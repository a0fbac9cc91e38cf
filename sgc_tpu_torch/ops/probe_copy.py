"""Kernel E, the compile-and-launch probes (``csrc/probe_copy.cu``).

The counterparts of the Pallas kernels of ``scripts/exp_pallas_probe.py``
(``y = 2 x``) and ``scripts/exp_pallas_probe2.py`` (a block copy whose
source block comes from a scalar-prefetch index). Two entries:

* :func:`scale2`: ``y = 2 x``, f32, any shape;
* :func:`select_blocks`: ``out[i B:(i + 1) B] = 2 x[sel[i] B:(sel[i] + 1)
  B]`` over the rows of a 2-D f32 ``x``, ``B`` rows a block; each CTA
  reads its own ``sel[i]`` on the card.

On a CUDA tensor each entry launches the kernel (counted once in
``LAUNCHES`` and in ``BY_ENTRY``) or raises; on a CPU tensor it runs its
plain version. Doubling is exact in f32, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from sgc_tpu_torch.ops import kernels

LAUNCHES = 0
BY_ENTRY = {"scale2": 0, "select_blocks": 0}


def _count(entry: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    BY_ENTRY[entry] += 1


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def scale2(x: torch.Tensor) -> torch.Tensor:
    """``2 x`` (f32): kernel E on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return scale2_plain(x)
    kernels.require_cuda_f32(x, "x")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rc = kernels.entry("probe_copy", "probe_scale2")(
        x.data_ptr(), y.data_ptr(), x.numel(), kernels.stream_of(x))
    kernels.check_launch(rc, "probe_scale2")
    _count("scale2")
    return y


def _check_select(x: torch.Tensor, sel: torch.Tensor, block: int) -> None:
    if x.dim() != 2 or block <= 0 or x.shape[0] % block:
        raise ValueError(f"x must be 2-D with rows a multiple of the block "
                         f"({block}), got {tuple(x.shape)}")
    if sel.dim() != 1 or sel.dtype != torch.int32:
        raise ValueError("sel must be a 1-D int32 tensor")
    if sel.device != x.device:
        raise ValueError(f"sel on {sel.device}, x on {x.device}")


def select_blocks_plain(x: torch.Tensor, sel: torch.Tensor,
                        block: int) -> torch.Tensor:
    _check_select(x, sel, block)
    xs = x.view(-1, block, x.shape[1])
    return (xs[sel.long()] * 2.0).reshape(-1, x.shape[1])


def select_blocks(x: torch.Tensor, sel: torch.Tensor,
                  block: int) -> torch.Tensor:
    """Block ``i`` of the output (``block`` rows) is 2 x block ``sel[i]``:
    kernel E on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return select_blocks_plain(x, sel, block)
    _check_select(x, sel, block)
    kernels.require_cuda_f32(x, "x")
    sel = sel.contiguous()
    out = torch.empty((sel.shape[0] * block, x.shape[1]),
                      dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rc = kernels.entry("probe_copy", "probe_select_blocks")(
        x.data_ptr(), sel.data_ptr(), out.data_ptr(), sel.shape[0],
        x.shape[0] // block, block * x.shape[1], kernels.stream_of(x))
    kernels.check_launch(rc, "probe_select_blocks")
    _count("select_blocks")
    return out
