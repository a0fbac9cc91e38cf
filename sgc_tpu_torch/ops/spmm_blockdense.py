"""Block-dense SpMM (the counterpart of sgc_tpu/ops/spmm_blockdense.py).

``S @ x`` split in two: the edges of dense (row_block x stripe) cells are
materialized as bf16 cells and multiplied as dense blocks; every other
edge stays in a sparse remainder. Host side (bit for bit the reference's):
:class:`BlockDenseSplit` and :func:`split_block_dense`, in both cell
orders (``super_rows=None``: (rb, st); ``super_rows=S``: (rb//S, st, rb)),
with ``group_cells`` holes and the tail padding.

Device side:

* :func:`spmm_blockdense` is the counterpart of ``spmm_blockdense_pallas``:
  the dense term through kernel A (``csrc/blockdense.cu``, wrapper
  :func:`apply_cells`) plus the remainder through kernel B
  (``ops/spmm.py::spmm_segment``), which adds the dense term in its
  epilogue. Output f32 ``[n_rows, F]``; row blocks no cell visits are
  zero.
* :func:`spmm_block_dense` is the plain PyTorch version of the same
  function (the reference's scan form): :func:`apply_cells_plain`, a loop
  over the cells with f32 matmuls and a fixed-order row-block add, plus
  :func:`spmm_segment_plain`.
* :func:`spmm_blockdense_graph` is the drop-in behind
  ``spmm(impl="blockdense")`` (the reference's ``spmm_blockdense(graph,
  x)``): split on first use and place the split once, both cached.

Cells are kept as raw bf16 bits in ``np.uint16`` on the host (as the
native ``cell_scatter`` writes them) and viewed as ``torch.bfloat16`` on
the device.

``precision`` (the reference's argument, same defaults) sets how x meets
the bf16 cells in the dense term; the remainder is f32 either way:

* ``"bf16"``: ``cell @ bf16(x)`` with f32 accumulation, what the
  reference computes (its MXU rounded x to bf16 even at ``"f32"``);
* ``"f32"``: the product agrees with an f32 product to f32 rounding.

Kernel A runs on the bf16 tensor cores and takes x as bf16 terms, which
its first stage writes into a scratch the wrapper allocates
(:func:`bf16_terms` is the plain twin): :func:`n_passes` terms, one for
``"bf16"`` and two for ``"f32"``, each a pass into the same f32
accumulator. The cells are exact in bf16, so only x is split. The plain
version computes ``cell.float() @ x`` in f32, on ``bf16(x)`` for
``"bf16"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch import native
from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain
from sgc_tpu_torch.utils.buildcache import placed

# Admission-model rates measured by the reference on a TPU v5e (its
# einsum cell path, and its XLA segment path, sgc_tpu/ops/spmm_hybrid.py).
# They say nothing about the H100: they are used only where
# calibrate=False, which keeps CPU parity with the reference
# deterministic. On the card, ops/calibrate.py measures both rates.
BLOCKDENSE_EFF_FLOPS = 2.6e13
XLA_EDGES_PER_S = 34e6

DEFAULT_ROW_BLOCK = 512
DEFAULT_STRIPE = 512
DEFAULT_BYTE_BUDGET = 4 << 30   # bf16 cell bytes per split
# tail padding granularity of the cell list (the reference's scan step)
CELL_CHUNK = 256

# calls of kernel A's entry by apply_cells; each call is two CUDA
# launches, the operand stage (x_terms_kernel) and then the MMA kernel
LAUNCHES = 0

PRECISIONS = ("f32", "bf16")
# kernel A's feature tile: the bf16 scratch of x is padded to a multiple
FEATURE_TILE = 128


def _scan_chunk(n_cells: int) -> int:
    """CELL_CHUNK, or the covering power of two for shorter lists."""
    return min(CELL_CHUNK, 1 << max(0, n_cells - 1).bit_length())


def min_edges_for(row_block: int, stripe: int, n_features: int,
                  eff_flops: float = BLOCKDENSE_EFF_FLOPS,
                  xla_edges_per_s: float = XLA_EDGES_PER_S) -> float:
    """Edges per cell above which the cell matmul beats the sparse path
    for that cell's edges."""
    f_pad = -(-max(n_features, 128) // 128) * 128
    cell_seconds = 2.0 * row_block * stripe * f_pad / eff_flops
    return cell_seconds * xla_edges_per_s


def default_feature_tile(n_features: int) -> int:
    """The reference's Pallas feature tile: one tile up to 1024 lanes,
    rounded up to 128. Kept for parity of the host-side API; kernel A
    tiles features by its own BN = 128."""
    return min(-(-max(int(n_features), 128) // 128) * 128, 1024)


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """A CPU bfloat16 tensor viewing raw bf16 bits held as uint16."""
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class BlockDenseSplit:
    """Host-side split: materialized cells + sparse remainder.

    ``cells`` holds bf16 bits, ``uint16[n_cells_pad, R, W]``. The cell
    list is padded at the tail to a multiple of the scan chunk with zero
    cells that repeat the last slot's (rb, st). ``n_slots`` counts the
    slots before that tail (equal to ``n_cells`` unless ``group_cells``
    added zero holes inside (panel, stripe) runs).
    """

    cells: np.ndarray
    rb_ids: np.ndarray            # int32[n_cells_pad]
    st_ids: np.ndarray            # int32[n_cells_pad]
    rest: SparseGraph | None      # host remainder
    n_rows: int
    n_cols: int
    row_block: int
    stripe: int
    n_cells: int                  # real (unpadded) cell count
    n_slots: int                  # slots before the tail padding
    dense_edges: int
    sparse_edges: int
    min_edges: float
    super_rows: int | None = None
    group_cells: int | None = None

    @property
    def cell_bytes(self) -> int:
        return self.cells.nbytes

    @property
    def n_row_blocks(self) -> int:
        return -(-self.n_rows // self.row_block)

    @property
    def n_stripes(self) -> int:
        return -(-self.n_cols // self.stripe)


def split_block_dense(
    graph: SparseGraph,
    n_features: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    stripe: int = DEFAULT_STRIPE,
    min_edges: float | None = None,
    byte_budget: int = DEFAULT_BYTE_BUDGET,
    super_rows: int | None = None,
    group_cells: int | None = None,
) -> BlockDenseSplit:
    """Partition edges by per-cell count; materialize qualifying cells.

    Host-side, O(E). A cell qualifies when its edge count exceeds
    ``min_edges`` (default :func:`min_edges_for` with the committed
    rates); qualifying cells are admitted densest-first up to
    ``byte_budget`` bf16 bytes, the rest of the edges form the remainder.
    """
    if min_edges is None:
        min_edges = min_edges_for(row_block, stripe, n_features)

    rows = host(graph.rows)[: graph.nnz].astype(np.int64)
    cols = host(graph.cols)[: graph.nnz].astype(np.int64)
    vals = host(graph.vals)[: graph.nnz].astype(np.float32)

    n_st = -(-graph.n_cols // stripe)
    if row_block & (row_block - 1) == 0 and stripe & (stripe - 1) == 0:
        cell = ((rows >> row_block.bit_length() - 1) * n_st
                + (cols >> stripe.bit_length() - 1))
    else:
        cell = (rows // row_block) * n_st + (cols // stripe)
    counts = np.bincount(
        cell, minlength=(-(-graph.n_rows // row_block)) * n_st)

    qualifying = np.flatnonzero(counts > min_edges)
    cell_bytes = 2 * row_block * stripe
    max_cells = max(int(byte_budget // cell_bytes), 0)
    if len(qualifying) > max_cells:
        order = np.argsort(-counts[qualifying], kind="stable")
        qualifying = np.sort(qualifying[order[:max_cells]])

    if group_cells is not None:
        if super_rows is None:
            raise ValueError("group_cells requires super_rows")
        if CELL_CHUNK % group_cells:
            raise ValueError(
                f"group_cells {group_cells} must divide CELL_CHUNK "
                f"{CELL_CHUNK} (tail padding must keep group alignment)")
    slot_rb = slot_st = None
    if super_rows is not None and len(qualifying):
        rbq = qualifying // n_st
        stq = qualifying % n_st
        qualifying = qualifying[np.lexsort((rbq, stq, rbq // super_rows))]
    compact = np.full(len(counts), -1, np.int64)
    n_cells = len(qualifying)
    slots = np.arange(n_cells)
    if group_cells is not None and n_cells:
        # pad each (panel, stripe) run to a multiple of G with zero-cell
        # holes that repeat the run's last (rb, st)
        G = group_cells
        rbq = qualifying // n_st
        stq = qualifying % n_st
        key = (rbq // super_rows) * n_st + stq
        run_start = np.concatenate(([True], key[1:] != key[:-1]))
        run_id = np.cumsum(run_start) - 1
        counts_r = np.bincount(run_id)
        padded_r = -(-counts_r // G) * G
        starts = np.concatenate(([0], np.cumsum(padded_r)[:-1]))
        cum_real = np.concatenate(([0], np.cumsum(counts_r)[:-1]))
        slots = starts[run_id] + (np.arange(n_cells) - cum_real[run_id])
        n_slot_total = int(padded_r.sum())
        slot_rb = np.zeros(n_slot_total, np.int32)
        slot_st = np.zeros(n_slot_total, np.int32)
        slot_rb[slots] = rbq
        slot_st[slots] = stq
        hole = np.ones(n_slot_total, bool)
        hole[slots] = False
        if hole.any():
            slot_run = np.repeat(np.arange(len(padded_r)), padded_r)
            last_idx = np.cumsum(counts_r) - 1
            slot_rb[hole] = rbq[last_idx][slot_run[hole]]
            slot_st[hole] = stq[last_idx][slot_run[hole]]
    compact[qualifying] = slots

    cells = np.zeros((0, row_block, stripe), np.uint16)
    rb_ids = np.zeros(0, np.int32)
    st_ids = np.zeros(0, np.int32)
    dense_mask = np.zeros(len(rows), np.bool_)
    n_slots = 0
    if n_cells:
        n_slots = len(slot_rb) if slot_rb is not None else n_cells
        pad = -n_slots % _scan_chunk(n_slots)
        cells = np.zeros((n_slots + pad) * row_block * stripe, np.uint16)
        mask_u8 = np.empty(len(rows), np.uint8)
        native.cell_scatter(rows, cols, vals, compact, n_st, row_block,
                            stripe, cells, mask_u8)
        dense_mask = mask_u8.view(np.bool_)
        cells = cells.reshape(n_slots + pad, row_block, stripe)
        if slot_rb is not None:
            rb_ids, st_ids = slot_rb, slot_st
        else:
            rb_ids = (qualifying // n_st).astype(np.int32)
            st_ids = (qualifying % n_st).astype(np.int32)
        if pad:
            rb_ids = np.concatenate(
                [rb_ids, np.full(pad, rb_ids[-1], np.int32)])
            st_ids = np.concatenate(
                [st_ids, np.full(pad, st_ids[-1], np.int32)])

    rest = None
    n_dense = int(dense_mask.sum())
    n_sparse = len(rows) - n_dense
    if n_sparse:
        rest = SparseGraph.from_coo(
            rows[~dense_mask], cols[~dense_mask], vals[~dense_mask],
            n_rows=graph.n_rows, n_cols=graph.n_cols, presorted=True)
    return BlockDenseSplit(
        cells=cells, rb_ids=rb_ids, st_ids=st_ids, rest=rest,
        n_rows=graph.n_rows, n_cols=graph.n_cols,
        row_block=row_block, stripe=stripe, n_cells=n_cells,
        n_slots=n_slots, dense_edges=n_dense, sparse_edges=n_sparse,
        min_edges=min_edges, super_rows=super_rows, group_cells=group_cells,
    )


def cell_index(split: BlockDenseSplit) -> tuple[np.ndarray, np.ndarray]:
    """Per-row-block cell index ``(rb_ptr int32[n_rb + 1], cell_of
    int32[n_slots])``: row block rb's slots are ``cell_of[rb_ptr[rb]:
    rb_ptr[rb + 1]]``, in ascending stripe order (slot order restricted
    to one row block is ascending st in both layouts; the sort is
    stable). The zero tail-padding slots are left out."""
    rb = split.rb_ids[: split.n_slots]
    cell_of = np.argsort(rb, kind="stable").astype(np.int32)
    rb_ptr = np.zeros(split.n_row_blocks + 1, np.int64)
    np.cumsum(np.bincount(rb, minlength=split.n_row_blocks),
              out=rb_ptr[1:])
    return rb_ptr.astype(np.int32), cell_of


@dataclasses.dataclass(frozen=True)
class BlockDenseArgs:
    """A split's arrays placed on one device (once per plan)."""

    cells: torch.Tensor | None        # bf16 [n_cells_pad, R, W]
    st_ids: torch.Tensor | None       # int32 [n_cells_pad]
    rb_ptr: torch.Tensor | None       # int32 [n_rb + 1]
    cell_of: torch.Tensor | None      # int32 [n_slots]
    rest: SparseGraph | None          # remainder on the device

    @property
    def device(self) -> torch.device | None:
        t = self.cells if self.cells is not None else (
            self.rest.rows if self.rest is not None else None)
        return None if t is None else t.device


def blockdense_device_args(split: BlockDenseSplit,
                           device) -> BlockDenseArgs:
    """Place ``split`` on ``device`` (an explicit device, no default)."""
    dev = torch.device(device)
    dense = dict(cells=None, st_ids=None, rb_ptr=None, cell_of=None)
    if split.n_cells:
        rb_ptr, cell_of = cell_index(split)
        dense = dict(
            cells=bf16_from_bits(split.cells).to(dev),
            st_ids=torch.from_numpy(split.st_ids).to(dev),
            rb_ptr=torch.from_numpy(rb_ptr).to(dev),
            cell_of=torch.from_numpy(cell_of).to(dev),
        )
    rest = split.rest.to(dev) if split.rest is not None else None
    return BlockDenseArgs(rest=rest, **dense)


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")


def n_passes(precision: str) -> int:
    """Kernel A's bf16 terms of x, one MMA pass each: 1 for ``"bf16"``, 2
    for ``"f32"`` (``|x - (hi + lo)| <= 2**-16 |x|``)."""
    check_precision(precision)
    return 1 if precision == "bf16" else 2


def bf16_terms(x: torch.Tensor, n_terms: int) -> list[torch.Tensor]:
    """x as ``n_terms`` bf16 tensors whose f32 sum approximates it:
    ``hi = bf16(x)``, ``lo = bf16(x - hi)``, ... (round to nearest even),
    the plain twin of kernel A's operand stage. Each term is exact in f32
    and each remainder is exact, so the error after ``n`` terms is at
    most ``2**(-8n) |x|``; three terms hold an f32 value exactly (bf16
    keeps 8 of f32's 24 significand bits)."""
    terms, r = [], x
    for t in range(n_terms):
        terms.append(r.to(torch.bfloat16))
        if t + 1 < n_terms:
            r = r - terms[-1].float()
    return terms


def apply_cells_plain(split: BlockDenseSplit, args: BlockDenseArgs,
                      x: torch.Tensor,
                      precision: str = "bf16") -> torch.Tensor:
    """The dense-cell term in plain PyTorch: for each row block, its
    cells in index order, ``acc += cell.float() @ x[stripe]`` in f32, on
    ``bf16(x)`` for ``precision="bf16"``. Row blocks with no cells stay
    zero."""
    check_precision(precision)
    R, W = split.row_block, split.stripe
    F = x.shape[1]
    xp = x.new_zeros((split.n_stripes * W, F))
    xp[: x.shape[0]] = (bf16_terms(x, 1)[0].float() if precision == "bf16"
                        else x)
    out = x.new_zeros((split.n_row_blocks * R, F))
    rb_ptr, cell_of = host(args.rb_ptr), host(args.cell_of)
    for rb in range(split.n_row_blocks):
        acc = out[rb * R:(rb + 1) * R]
        for k in cell_of[rb_ptr[rb]:rb_ptr[rb + 1]]:
            st = int(split.st_ids[k])
            acc += args.cells[k].float() @ xp[st * W:(st + 1) * W]
    return out[: split.n_rows]


def apply_cells(split: BlockDenseSplit, args: BlockDenseArgs,
                x: torch.Tensor, precision: str = "bf16") -> torch.Tensor:
    """The dense-cell term, f32 ``[n_rows, F]``: kernel A on a CUDA
    tensor (or raise), :func:`apply_cells_plain` on a CPU tensor. One
    call of kernel A's entry, counted once in ``LAUNCHES``, launches its
    operand stage and its MMA kernel."""
    check_precision(precision)
    if x.dim() != 2 or x.shape[0] != split.n_cols:
        raise ValueError(f"x must be [{split.n_cols}, F], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return apply_cells_plain(split, args, x, precision)
    global LAUNCHES
    kernels.require_cuda_f32(x, "x")
    if args.cells is None or args.cells.device != x.device:
        raise ValueError("the split's cells are not placed on x's device")
    R, W = split.row_block, split.stripe
    if (args.cells.dtype != torch.bfloat16 or not args.cells.is_contiguous()
            or tuple(args.cells.shape[1:]) != (R, W)):
        raise ValueError(f"cells must be contiguous bf16 [C, {R}, {W}]")
    F = int(x.shape[1])
    out = torch.empty((split.n_rows, F), dtype=torch.float32,
                      device=x.device)
    if split.n_rows == 0 or F == 0:
        return out
    n_terms = n_passes(precision)
    f_pad = -(-F // FEATURE_TILE) * FEATURE_TILE
    n_x_rows = split.n_stripes * W
    # the kernel writes x's bf16 terms here (zero-padded), then reads them
    xs = torch.empty((n_terms, n_x_rows, f_pad), dtype=torch.bfloat16,
                     device=x.device)
    rc = kernels.entry("blockdense")(
        args.cells.data_ptr(), x.data_ptr(), xs.data_ptr(), out.data_ptr(),
        args.rb_ptr.data_ptr(), args.cell_of.data_ptr(),
        args.st_ids.data_ptr(), split.n_row_blocks, split.n_rows,
        split.n_cols, n_x_rows, F, f_pad, R, W, n_terms,
        kernels.stream_of(x))
    kernels.check_launch(rc, "blockdense_cells")
    LAUNCHES += 1
    return out


def _check_args(split: BlockDenseSplit, args: BlockDenseArgs,
                x: torch.Tensor) -> None:
    if split.n_cells and args.cells is None:
        raise ValueError("split has dense cells but args carry none")
    if split.rest is not None and args.rest is None:
        raise ValueError("split has a sparse remainder but args carry none")
    if args.device is not None and args.device != x.device:
        raise ValueError(f"args on {args.device}, x on {x.device}")


def spmm_blockdense(split: BlockDenseSplit, x: torch.Tensor,
                    args: BlockDenseArgs | None = None,
                    precision: str = "bf16") -> torch.Tensor:
    """``S @ x`` as dense-cell term + remainder through the kernels
    (kernel A, then kernel B adding the dense term in its epilogue).
    The counterpart of the reference's ``spmm_blockdense_pallas``."""
    check_precision(precision)
    if args is None:
        args = blockdense_device_args(split, x.device)
    _check_args(split, args, x)
    dense = (apply_cells(split, args, x, precision) if split.n_cells
             else None)
    if args.rest is not None:
        return spmm_segment(args.rest, x, dense)
    if dense is not None:
        return dense
    return x.new_zeros((split.n_rows, x.shape[1]))


def spmm_block_dense(split: BlockDenseSplit, x: torch.Tensor,
                     args: BlockDenseArgs | None = None,
                     precision: str = "bf16") -> torch.Tensor:
    """The plain PyTorch version of :func:`spmm_blockdense` (the
    reference's scan form): the same function with no kernel."""
    check_precision(precision)
    if args is None:
        args = blockdense_device_args(split, x.device)
    _check_args(split, args, x)
    dense = (apply_cells_plain(split, args, x, precision) if split.n_cells
             else None)
    if args.rest is not None:
        return spmm_segment_plain(args.rest, x, dense)
    if dense is not None:
        return dense
    return x.new_zeros((split.n_rows, x.shape[1]))


def spmm_blockdense_graph(graph: SparseGraph, x: torch.Tensor,
                          row_block: int = DEFAULT_ROW_BLOCK,
                          stripe: int = DEFAULT_STRIPE,
                          precision: str = "bf16") -> torch.Tensor:
    """Drop-in block-dense SpMM: split with the committed admission and
    place it on x's device on first use (cached with
    ``utils.buildcache.placed``: the split is O(E) host work plus GBs of
    cells), then :func:`spmm_blockdense`."""
    F = int(x.shape[1])
    split, args = placed(
        graph, ("blockdense", F, row_block, stripe), x.device,
        lambda: split_block_dense(graph, F, row_block, stripe),
        blockdense_device_args)
    return spmm_blockdense(split, x, args, precision)
