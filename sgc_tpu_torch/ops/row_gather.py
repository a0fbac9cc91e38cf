"""Kernel F, the row gather ``out[i, :] = x[idx[i], :]``
(``csrc/row_gather.cu``).

The counterpart of the Pallas kernels of ``scripts/exp_take_probe.py``
(an in-kernel vectorized gather in three JAX spellings, ``jnp.take``,
``x[idx]`` and ``take_along_axis``: one function) and
``scripts/exp_dma_gather_probe.py`` (one asynchronous DMA a row at an
offset read at run time). Two entries of one function:

* ``"load"``: warps copy rows with 16-byte vector loads;
* ``"async"``: rows go through shared memory by ``cp.async`` copies,
  ``in_flight`` rows (1, 2, 4, 8 or 16) in flight per CTA.

On a CUDA tensor :func:`row_gather` launches the kernel (counted once in
``LAUNCHES`` and in ``BY_ENTRY``) or raises; on a CPU tensor it runs
:func:`row_gather_plain`. Both copy bits, so they agree exactly.
"""

from __future__ import annotations

import torch

from sgc_tpu_torch.ops import kernels

ENTRIES = ("load", "async")
IN_FLIGHT = (1, 2, 4, 8, 16)
DEFAULT_IN_FLIGHT = 8

LAUNCHES = 0
BY_ENTRY = {e: 0 for e in ENTRIES}


def _check(x: torch.Tensor, idx: torch.Tensor, entry: str,
           in_flight: int) -> None:
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}; one of {ENTRIES}")
    if in_flight not in IN_FLIGHT:
        raise ValueError(f"in_flight must be one of {IN_FLIGHT}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError("idx must be a 1-D int32 tensor")
    if idx.device != x.device:
        raise ValueError(f"idx on {idx.device}, x on {x.device}")


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


def row_gather(x: torch.Tensor, idx: torch.Tensor, entry: str = "load",
               in_flight: int = DEFAULT_IN_FLIGHT) -> torch.Tensor:
    """``x[idx]`` (x f32 ``[n, F]``, idx int32): kernel F through
    ``entry`` on a CUDA tensor, the plain version on a CPU tensor."""
    _check(x, idx, entry, in_flight)
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    global LAUNCHES
    kernels.require_cuda_f32(x, "x")
    idx = idx.contiguous()
    n_out, F = int(idx.shape[0]), int(x.shape[1])
    out = torch.empty((n_out, F), dtype=torch.float32, device=x.device)
    if n_out == 0 or F == 0:
        return out
    if entry == "load":
        rc = kernels.entry("row_gather", "row_gather_load")(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out, F,
            x.shape[0], kernels.stream_of(x))
    else:
        rc = kernels.entry("row_gather", "row_gather_async")(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out, F,
            x.shape[0], in_flight, kernels.stream_of(x))
    kernels.check_launch(rc, f"row_gather_{entry}")
    LAUNCHES += 1
    BY_ENTRY[entry] += 1
    return out
