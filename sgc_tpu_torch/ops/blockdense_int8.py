"""Kernel H, the dense-cell term on int8 cells (``csrc/blockdense_int8.cu``).

The counterpart of the int8 leg of ``scripts/exp_dense_term.py``: a
block-dense split's bf16 cells quantized per cell,

    scale = max(max |cell|, 1e-30) / 127,   q = clip(rint(cell / scale), ±127)

(:func:`quantize_cells`, bit for bit the reference's numpy, in f32 with
ties to even), and the term

    out[rb] = sum over the row block's cells of bf16(f32(q) * scale) @ xs[st]

summed in f32, with x given as the reference gives it: a bf16 table of
``n_st * W`` rows, its features zero-padded to a multiple of a feature
tile (:func:`pad_x_bf16`). The output is ``[n_rb * R, F_pad]``, zero in
row blocks with no cell.

The reference's kernel zeroes its output block whenever the row-block id
changes between grid steps, which is right only for cells in (rb, st)
order; here the cells of any order are indexed per row block
(:func:`int8_cells`, as kernel A's ``cell_index``), so both orders give
the intended function.

On a CUDA tensor :func:`apply_cells_int8` launches the kernel (counted as
``launch.blockdense_int8_cells``) or raises; on a CPU tensor it runs
:func:`apply_cells_int8_plain`, a loop over each row block's cells with
f32 matmuls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.utils.profiling import count

# cells a quantization step takes at once (an f32 temporary of this many
# cells; the reference's chunk)
QUANT_CHUNK = 256
# F_pad must be a multiple of it: the kernel's tiles are 256 features
# wide, the last one 128 wide where F_pad is not a multiple of 256
FEATURE_TILE = 128


def quantize_cells(cells: torch.Tensor,
                   chunk: int = QUANT_CHUNK) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """``(q int8 [k, R, W], scales f32 [k])`` of bf16 cells ``[k, R, W]``,
    on their device, the reference's numpy recipe in f32."""
    if cells.dim() != 3 or cells.dtype != torch.bfloat16:
        raise ValueError("cells must be bf16 [k, R, W]")
    k = cells.shape[0]
    q = torch.empty(cells.shape, dtype=torch.int8, device=cells.device)
    scales = torch.empty(k, dtype=torch.float32, device=cells.device)
    for i in range(0, k, chunk):
        cf = cells[i:i + chunk].float()
        sc = cf.abs().amax(dim=(1, 2)).clamp_min(1e-30) / 127.0
        scales[i:i + chunk] = sc
        q[i:i + chunk] = torch.round(cf / sc[:, None, None]).clamp_(
            -127, 127).to(torch.int8)
    return q, scales


def pad_x_bf16(x: torch.Tensor, n_x_rows: int,
               feature_tile: int) -> torch.Tensor:
    """x zero-padded to ``n_x_rows`` rows and to a multiple of
    ``feature_tile`` features, as bf16 (the reference's ``jnp.pad(...)
    .astype(bfloat16)``)."""
    if x.dim() != 2 or x.shape[0] > n_x_rows:
        raise ValueError(f"x must be 2-D with at most {n_x_rows} rows")
    f_pad = -(-x.shape[1] // feature_tile) * feature_tile
    xp = torch.zeros((n_x_rows, f_pad), dtype=torch.bfloat16,
                     device=x.device)
    xp[: x.shape[0], : x.shape[1]] = x.to(torch.bfloat16)
    return xp


@dataclasses.dataclass(frozen=True)
class Int8Cells:
    """Quantized cells and their row-block index, on one device."""

    cells: torch.Tensor     # int8 [k, R, W]
    scales: torch.Tensor    # f32 [k]
    st_ids: torch.Tensor    # int32 [k]
    rb_ptr: torch.Tensor    # int32 [n_rb + 1]
    cell_of: torch.Tensor   # int32 [k]: slots by row block, in slot order
    n_rb: int
    n_st: int

    @property
    def row_block(self) -> int:
        return int(self.cells.shape[1])

    @property
    def stripe(self) -> int:
        return int(self.cells.shape[2])


def _ids(a, device) -> torch.Tensor:
    """An id array (a tensor, or a host array copied) on ``device``."""
    return (a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
            ).to(device)


def int8_cells(q: torch.Tensor, scales: torch.Tensor, rb_ids, st_ids,
               n_rb: int, n_st: int) -> Int8Cells:
    """Index quantized cells by row block (slots of one row block in slot
    order), on ``q``'s device; every slot counts, the split's tail padding
    included (zero cells add zero)."""
    dev = q.device
    rb = _ids(rb_ids, dev).long()
    st = _ids(st_ids, dev).to(torch.int32).contiguous()
    k = q.shape[0]
    if scales.shape != (k,) or rb.shape != (k,) or st.shape != (k,):
        raise ValueError("scales, rb_ids and st_ids need one entry a cell")
    counts = torch.bincount(rb, minlength=n_rb)
    if counts.numel() != n_rb or (k and int(rb.min()) < 0):
        raise ValueError(f"rb_ids out of [0, {n_rb})")
    rb_ptr = torch.zeros(n_rb + 1, dtype=torch.int64, device=dev)
    rb_ptr[1:] = torch.cumsum(counts, 0)
    cell_of = torch.argsort(rb, stable=True).to(torch.int32)
    return Int8Cells(cells=q.contiguous(), scales=scales.contiguous(),
                     st_ids=st, rb_ptr=rb_ptr.to(torch.int32),
                     cell_of=cell_of, n_rb=n_rb, n_st=n_st)


def _check(c: Int8Cells, xp: torch.Tensor) -> None:
    R, W = c.row_block, c.stripe
    if xp.dim() != 2 or xp.dtype != torch.bfloat16 or \
            xp.shape[0] != c.n_st * W:
        raise ValueError(f"xs must be bf16 [{c.n_st * W}, F_pad], got "
                         f"{xp.dtype} {tuple(xp.shape)}")
    if xp.device != c.cells.device:
        raise ValueError(f"xs on {xp.device}, cells on {c.cells.device}")
    if c.cells.dtype != torch.int8:
        raise ValueError("cells must be int8")


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``bf16(f32(q) * scale)`` widened to f32."""
    return (q.float() * scale).to(torch.bfloat16).float()


def apply_cells_int8_plain(c: Int8Cells, xp: torch.Tensor) -> torch.Tensor:
    _check(c, xp)
    R, W = c.row_block, c.stripe
    xf = xp.float()
    out = xf.new_zeros((c.n_rb * R, xp.shape[1]))
    rb_ptr = c.rb_ptr.tolist()
    cell_of = c.cell_of.tolist()
    st_ids = c.st_ids.tolist()
    for rb in range(c.n_rb):
        acc = out[rb * R:(rb + 1) * R]
        for k in cell_of[rb_ptr[rb]:rb_ptr[rb + 1]]:
            st = st_ids[k]
            acc += dequantize(c.cells[k], c.scales[k]) @ \
                xf[st * W:(st + 1) * W]
    return out


def apply_cells_int8(c: Int8Cells, xp: torch.Tensor) -> torch.Tensor:
    """The int8 dense-cell term, f32 ``[n_rb * R, F_pad]``: kernel H on a
    CUDA tensor (F_pad a multiple of 128, R of 128, W of 128), the plain
    version on a CPU tensor."""
    _check(c, xp)
    if xp.device.type == "cpu":
        return apply_cells_int8_plain(c, xp)
    xp = xp.contiguous()
    R, W = c.row_block, c.stripe
    f_pad = int(xp.shape[1])
    if f_pad % FEATURE_TILE:
        raise ValueError(f"the kernel takes F_pad a multiple of "
                         f"{FEATURE_TILE}, got {f_pad}")
    out = torch.empty((c.n_rb * R, f_pad), dtype=torch.float32,
                      device=xp.device)
    rc = kernels.entry("blockdense_int8")(
        c.cells.data_ptr(), c.scales.data_ptr(), xp.data_ptr(),
        out.data_ptr(), c.rb_ptr.data_ptr(), c.cell_of.data_ptr(),
        c.st_ids.data_ptr(), int(c.cells.shape[0]), c.n_rb, c.n_st, f_pad,
        R, W, kernels.stream_of(xp))
    kernels.check_launch(rc, "blockdense_int8_cells")
    count("launch.blockdense_int8_cells")
    return out
