"""Tiled SpMM over a cell-chunk layout (the counterpart of
sgc_tpu/ops/spmm_pallas.py).

Host side, bit for bit the reference's: :class:`TiledGraph` and
:func:`tile_graph` sort the edges into (row block R x stripe W) cells and
pad each cell to whole chunks of C slots, through the native counting
sort (``native.tile_fill``); :func:`tile_graph_plain` is the reference's
numpy lexsort twin, kept as the plain version the tests hold the native
path against. :func:`_flat_schedule` and :func:`_tile_cached` are the
reference's. ``chunk`` is kept as given, 1024 included, so the layouts
compare bit for bit; the reference's ``chunk % 1024`` rule for compiled
runs was a Mosaic floor, and kernel C takes any chunk >= 1. The
reference's ``DEFAULT_FEATURE_TILE`` has no counterpart: a warp of
kernel C holds a whole row's features.

Device side: kernel C computes, for every row, the sum over its edge
slots in layout order of ``vals[e] * x[cols[e]]``. Both TPU kernels
visit the chunks in layout order, so the host re-sorts the layout's edges
once per layout into that order per row (:func:`row_index`, native
counting sort, and :func:`row_index_plain`, its numpy twin, give the
permutation; :func:`row_csr` gathers the edges through it). Padding slots
(the rest of each cell's last chunk, :func:`chunk_nnz`) are left out.
The result is a CSR matrix whose product, summed row by row in order, is
the tiled SpMM, so kernel C is the port's CSR kernel
(``csrc/spmm_csr.cu``, kernel B's) launched on it, counted in this
registry as ``launch.tiled_spmm``. One placement serves both entries:

* :func:`spmm_tiled_flat` <-> ``spmm_pallas_flat`` (the flat chunk
  schedule; :func:`flat_index` is that schedule, which the tests hold
  against the reference's);
* :func:`spmm_tiled_stripes` <-> ``spmm_pallas_tiled`` (the stripe walk
  over ``cell_start``/``cell_nchunks``, :func:`stripe_index`): the same
  launch, after checking that the layout is cell-major, as that walk
  needs;
* :func:`spmm_tiled` <-> ``spmm_pallas``: tile and place on first use
  (cached with :func:`sgc_tpu_torch.utils.buildcache.placed`), then the
  flat entry.

Each returns f32 ``[n_rows, F]``; the reference's padded ``[n_rb * R,
F_pad]`` output and its 128-lane feature tile were TPU layout. On a CUDA
tensor the wrappers launch kernel C or raise; on a CPU tensor they run
:func:`spmm_tiled_plain`, the plain PyTorch version (an ``index_add_``
over the layout's slots in layout order).

``precision`` is the reference's (default ``"f32"``). At ``"bf16"`` each
slot adds ``bf16(val * bf16(x[col]))`` to an f32 sum, as the reference's
one-hot gather and scatter matmuls take it (spmm_pallas.py:415-421): the
wrapper hands kernel C a bf16 copy of x and the kernel rounds each
product to bf16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch import native
from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.spmm import bf16_round, check_precision, launch_csr
from sgc_tpu_torch.utils.buildcache import placed
from sgc_tpu_torch.utils.profiling import count

DEFAULT_ROW_BLOCK = 2048     # R
DEFAULT_STRIPE = 2048        # W
DEFAULT_CHUNK = 1024         # C (slots per chunk)

# slots per index_add_ in the plain version: bounds its (slots, F)
# gather to ~2.5 GB at F = 602
PLAIN_SLOTS = 1 << 20



@dataclasses.dataclass(frozen=True)
class TiledGraph:
    """Cell-tiled edge layout.

    Edge arrays are the cells' chunk slices, concatenated cell-major
    (cells ordered by ``rb * n_st + st``); ``cell_start[rb, st]`` (in
    chunks) and ``cell_nchunks[rb, st]`` index them. Padding slots have
    ``val == 0`` and the cell's base (row, col). ``cell_nnz`` (the edges
    of each cell, so the rest of its last chunk is padding) is the port's
    addition; every other field is the reference's.
    """

    rows: np.ndarray          # int32[n_chunks * C]
    cols: np.ndarray          # int32[n_chunks * C]
    vals: np.ndarray          # float32[n_chunks * C]
    cell_start: np.ndarray    # int32[n_rb, n_st]
    cell_nchunks: np.ndarray  # int32[n_rb, n_st]
    cell_nnz: np.ndarray      # int32[n_rb, n_st]
    n_rows: int
    n_cols: int
    row_block: int
    stripe: int
    chunk: int

    @property
    def n_row_blocks(self) -> int:
        return self.cell_start.shape[0]

    @property
    def n_stripes(self) -> int:
        return self.cell_start.shape[1]

    @property
    def n_chunks(self) -> int:
        return int(self.rows.shape[0]) // self.chunk


def _cells(graph: SparseGraph, row_block: int, stripe: int, chunk: int):
    """The shared prologue of both tilers: edges, cell ids, per-cell
    counts and chunk offsets."""
    if min(row_block, stripe, chunk) < 1:
        raise ValueError("row_block, stripe and chunk must be >= 1")
    rows = host(graph.rows)[: graph.nnz].astype(np.int64)
    cols = host(graph.cols)[: graph.nnz].astype(np.int64)
    vals = host(graph.vals)[: graph.nnz].astype(np.float32)
    n_rb = -(-graph.n_rows // row_block)
    n_st = -(-graph.n_cols // stripe)
    cell = (rows // row_block) * n_st + (cols // stripe)
    counts = np.bincount(cell, minlength=n_rb * n_st)
    nchunks = -(-counts // chunk)
    cell_start = np.zeros(n_rb * n_st, np.int64)
    np.cumsum(nchunks[:-1], out=cell_start[1:])
    return rows, cols, vals, cell, counts, nchunks, cell_start, n_rb, n_st


def _tiled(graph, arrays, counts, nchunks, cell_start, n_rb, n_st,
           row_block, stripe, chunk) -> TiledGraph:
    r_out, c_out, v_out = arrays
    return TiledGraph(
        rows=r_out, cols=c_out, vals=v_out,
        cell_start=cell_start.astype(np.int32).reshape(n_rb, n_st),
        cell_nchunks=nchunks.astype(np.int32).reshape(n_rb, n_st),
        cell_nnz=counts.astype(np.int32).reshape(n_rb, n_st),
        n_rows=graph.n_rows, n_cols=graph.n_cols,
        row_block=row_block, stripe=stripe, chunk=chunk,
    )


def tile_graph(graph: SparseGraph, row_block: int = DEFAULT_ROW_BLOCK,
               stripe: int = DEFAULT_STRIPE,
               chunk: int = DEFAULT_CHUNK) -> TiledGraph:
    """Sort edges into (row block, stripe) cells and pad each cell to
    chunks, through the native counting sort (raises when the host
    library cannot be built). Host-side, done once per graph."""
    rows, cols, vals, cell, counts, nchunks, cell_start, n_rb, n_st = (
        _cells(graph, row_block, stripe, chunk))
    arrays = native.tile_fill(rows, cols, vals, cell, cell_start, counts,
                              chunk, n_st, row_block, stripe,
                              int(nchunks.sum()))
    return _tiled(graph, arrays, counts, nchunks, cell_start, n_rb, n_st,
                  row_block, stripe, chunk)


def tile_graph_plain(graph: SparseGraph,
                     row_block: int = DEFAULT_ROW_BLOCK,
                     stripe: int = DEFAULT_STRIPE,
                     chunk: int = DEFAULT_CHUNK) -> TiledGraph:
    """The same layout with the reference's numpy lexsort and scatter
    (the plain version of :func:`tile_graph`)."""
    rows, cols, vals, cell, counts, nchunks, cell_start, n_rb, n_st = (
        _cells(graph, row_block, stripe, chunk))
    n_slots = int(nchunks.sum()) * chunk
    order = np.lexsort((rows, cell))
    rows, cols, vals, cl = rows[order], cols[order], vals[order], cell[order]
    r_out = np.zeros(n_slots, np.int32)
    c_out = np.zeros(n_slots, np.int32)
    v_out = np.zeros(n_slots, np.float32)
    in_cell_pos = np.arange(len(rows)) - np.concatenate(
        ([0], np.cumsum(counts)))[cl]
    dst = cell_start[cl] * chunk + in_cell_pos
    r_out[dst] = rows
    c_out[dst] = cols
    v_out[dst] = vals
    pad_mask = np.ones(n_slots, bool)
    pad_mask[dst] = False
    if pad_mask.any():
        pad_cell = np.repeat(np.arange(n_rb * n_st),
                             nchunks * chunk)[pad_mask]
        r_out[pad_mask] = (pad_cell // n_st) * row_block
        c_out[pad_mask] = (pad_cell % n_st) * stripe
    return _tiled(graph, (r_out, c_out, v_out), counts, nchunks,
                  cell_start, n_rb, n_st, row_block, stripe, chunk)


def _flat_schedule(tiled: TiledGraph) -> tuple[np.ndarray, np.ndarray]:
    """Per-chunk (row block, stripe) ids in the chunks' order; chunks are
    cell-major, so ``chunk_rb`` is non-decreasing."""
    n_st = tiled.n_stripes
    cell_ids = np.repeat(np.arange(tiled.n_row_blocks * n_st),
                         tiled.cell_nchunks.reshape(-1))
    return ((cell_ids // n_st).astype(np.int32),
            (cell_ids % n_st).astype(np.int32))


def flat_index(tiled: TiledGraph) -> tuple[np.ndarray, np.ndarray]:
    """The flat chunk schedule as a per-row-block chunk index (the
    ``spmm_pallas_flat`` entry): ``(rb_chunk_ptr int32[n_rb + 1],
    chunk_st int32[n_chunks])``; row block rb's chunks are
    ``[rb_chunk_ptr[rb], rb_chunk_ptr[rb+1])``."""
    chunk_rb, chunk_st = _flat_schedule(tiled)
    ptr = np.zeros(tiled.n_row_blocks + 1, np.int64)
    np.cumsum(np.bincount(chunk_rb, minlength=tiled.n_row_blocks),
              out=ptr[1:])
    return ptr.astype(np.int32), chunk_st


def stripe_index(tiled: TiledGraph) -> tuple[np.ndarray, np.ndarray]:
    """The stripe walk over ``cell_start`` and ``cell_nchunks`` as the
    same chunk index (the ``spmm_pallas_tiled`` entry): the arrays of
    :func:`flat_index`. Raises when the chunks are not cell-major."""
    start = tiled.cell_start.reshape(-1).astype(np.int64)
    n = tiled.cell_nchunks.reshape(-1).astype(np.int64)
    first = np.concatenate(([0], np.cumsum(n)[:-1]))
    if not np.array_equal(start, first):
        raise ValueError("the tiled layout's chunks are not cell-major")
    total = int(n.sum())
    chunk_st = np.empty(total, np.int32)
    slot = np.repeat(start, n) + np.arange(total) - np.repeat(first, n)
    chunk_st[slot] = np.repeat(
        np.tile(np.arange(tiled.n_stripes), tiled.n_row_blocks), n)
    ptr = np.append(tiled.cell_start[:, 0].astype(np.int64), total)
    return ptr.astype(np.int32), chunk_st


def chunk_nnz(tiled: TiledGraph) -> np.ndarray:
    """Edges per chunk, int32[n_chunks] in layout order: every chunk of a
    cell is full but the last, whose remaining slots are padding."""
    n = tiled.cell_nchunks.reshape(-1).astype(np.int64)
    nnz = np.repeat(tiled.cell_nnz.reshape(-1).astype(np.int64), n)
    in_cell = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    return np.clip(nnz - in_cell * tiled.chunk, 0,
                   tiled.chunk).astype(np.int32)


def row_index(tiled: TiledGraph) -> tuple[np.ndarray, np.ndarray]:
    """The layout's row order: ``(row_ptr int32[n_rows + 1], perm
    int32[edges])``, the edge slots of every chunk (padding left out) in
    (row, layout position) order, so row r's edges are
    ``perm[row_ptr[r]:row_ptr[r + 1]]`` in the order both TPU schedules
    sum them. Native counting sort (raises when the host library cannot
    be built)."""
    return native.slot_row_index(tiled.rows, chunk_nnz(tiled), tiled.chunk,
                                 tiled.n_rows)


def row_index_plain(tiled: TiledGraph) -> tuple[np.ndarray, np.ndarray]:
    """:func:`row_index` with numpy's stable argsort (its plain twin)."""
    real = (np.arange(tiled.chunk)[None, :]
            < chunk_nnz(tiled)[:, None]).reshape(-1)
    slots = np.flatnonzero(real)
    rows = tiled.rows[slots]
    perm = slots[np.argsort(rows, kind="stable")].astype(np.int32)
    row_ptr = np.zeros(tiled.n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=tiled.n_rows), out=row_ptr[1:])
    return row_ptr.astype(np.int32), perm


def row_csr(tiled: TiledGraph,
            index: tuple[np.ndarray, np.ndarray] | None = None
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel C's operand: ``(row_ptr, cols, vals)``, the layout's edges
    as a CSR matrix in (row, layout position) order, gathered through
    ``index`` (default :func:`row_index`)."""
    row_ptr, perm = row_index(tiled) if index is None else index
    return row_ptr, tiled.cols[perm], tiled.vals[perm]


@dataclasses.dataclass(frozen=True)
class TiledArgs:
    """Kernel C's operand (:func:`row_csr`) placed on one device."""

    row_ptr: torch.Tensor         # int32 [n_rows + 1]
    cols: torch.Tensor            # int32 [edges]
    vals: torch.Tensor            # f32 [edges]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device


def tiled_device_args(tiled: TiledGraph, device,
                      csr: tuple[np.ndarray, ...] | None = None
                      ) -> TiledArgs:
    """Place ``csr`` (default ``row_csr(tiled)``) on ``device`` (an
    explicit device, no default)."""
    dev = torch.device(device)
    row_ptr, cols, vals = row_csr(tiled) if csr is None else csr
    return TiledArgs(row_ptr=torch.as_tensor(row_ptr, device=dev),
                     cols=torch.as_tensor(cols, device=dev),
                     vals=torch.as_tensor(vals, device=dev))


def spmm_tiled_plain(tiled: TiledGraph, x: torch.Tensor,
                     precision: str = "f32") -> torch.Tensor:
    """The tiled SpMM in plain PyTorch: ``index_add_`` of ``vals *
    x[cols]`` (at ``"bf16"``: ``bf16(vals * bf16(x[cols]))``) at ``rows``
    over every slot of the host layout in layout order (padding slots add
    0). Row blocks with no chunk stay zero."""
    _check_x(tiled, x)
    check_precision(precision)
    out = torch.zeros((tiled.n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, int(tiled.rows.shape[0]), PLAIN_SLOTS):
        e = slice(s, s + PLAIN_SLOTS)
        rows, cols, vals = (torch.as_tensor(a[e], device=x.device)
                            for a in (tiled.rows, tiled.cols, tiled.vals))
        xs = x[cols.long()]
        if precision == "bf16":
            slot = bf16_round(bf16_round(xs) * vals[:, None])
        else:
            slot = xs * vals[:, None]
        out.index_add_(0, rows.long(), slot)
    return out


def _check_x(tiled: TiledGraph, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != tiled.n_cols:
        raise ValueError(f"x must be [{tiled.n_cols}, F], got "
                         f"{tuple(x.shape)}")


def _apply(tiled: TiledGraph, x: torch.Tensor, args: TiledArgs,
           precision: str) -> torch.Tensor:
    """Kernel C on a CUDA tensor (or raise), the plain version on a CPU
    tensor."""
    _check_x(tiled, x)
    check_precision(precision)
    if args.device != x.device:
        raise ValueError(f"args on {args.device}, x on {x.device}")
    if x.device.type == "cpu":
        return spmm_tiled_plain(tiled, x, precision)
    kernels.require_cuda_f32(x, "x")
    for name, t, dt in (("row_ptr", args.row_ptr, torch.int32),
                        ("cols", args.cols, torch.int32),
                        ("vals", args.vals, torch.float32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"args.{name} must be contiguous {dt}")
    edges = int(args.cols.shape[0])
    if (args.row_ptr.shape[0] != tiled.n_rows + 1
            or args.vals.shape[0] != edges
            or edges > tiled.n_chunks * tiled.chunk):
        raise ValueError("args do not match the tiled layout")
    F = int(x.shape[1])
    if edges == 0 or tiled.n_rows == 0 or F == 0:
        return torch.zeros((tiled.n_rows, F), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((tiled.n_rows, F), dtype=torch.float32,
                      device=x.device)
    xk = x.to(torch.bfloat16) if precision == "bf16" else x
    launch_csr(args.row_ptr, args.cols, args.vals, xk, None, out,
               x_bf16=precision == "bf16")
    count("launch.tiled_spmm")
    return out


def spmm_tiled_flat(tiled: TiledGraph, x: torch.Tensor,
                    args: TiledArgs | None = None,
                    precision: str = "f32") -> torch.Tensor:
    """``S @ x`` over a tiled layout, f32 ``[n_rows, F]``, by the flat
    chunk schedule (the counterpart of ``spmm_pallas_flat``)."""
    if args is None:
        args = tiled_device_args(tiled, x.device)
    return _apply(tiled, x, args, precision)


def spmm_tiled_stripes(tiled: TiledGraph, x: torch.Tensor,
                       args: TiledArgs | None = None,
                       precision: str = "f32") -> torch.Tensor:
    """``S @ x`` over a tiled layout, f32 ``[n_rows, F]``, by the stripe
    walk (the counterpart of ``spmm_pallas_tiled``): the flat entry's
    launch on a layout checked to be cell-major."""
    stripe_index(tiled)   # raises unless the chunks are cell-major
    return spmm_tiled_flat(tiled, x, args, precision)


def _tile_cached(graph: SparseGraph, row_block: int, stripe: int,
                 chunk: int, device) -> tuple[TiledGraph, TiledArgs]:
    """The tiling of ``graph`` and its placement on ``device``, built on
    first use (``utils.buildcache.placed``): tiling is O(E) host work and
    placing it uploads every slot, and a K-hop loop must do neither per
    hop."""
    return placed(graph, ("tiled", row_block, stripe, chunk), device,
                  lambda: tile_graph(graph, row_block, stripe, chunk),
                  tiled_device_args)


def spmm_tiled(graph: SparseGraph, x: torch.Tensor,
               row_block: int = DEFAULT_ROW_BLOCK,
               stripe: int = DEFAULT_STRIPE,
               chunk: int = DEFAULT_CHUNK,
               precision: str = "f32") -> torch.Tensor:
    """Drop-in tiled SpMM (the counterpart of ``spmm_pallas``): tile and
    place on x's device on first use (cached), then the flat entry."""
    tiled, args = _tile_cached(graph, row_block, stripe, chunk, x.device)
    return spmm_tiled_flat(tiled, x, args, precision)
