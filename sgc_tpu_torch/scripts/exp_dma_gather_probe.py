"""Probe: a gather by asynchronous row copies at offsets read at run time
(the counterpart of scripts/exp_dma_gather_probe.py).

The reference issues one DMA a row (``make_async_copy`` at ``x_hbm.at[
pl.ds(col, 1)]``, ``col`` read in the kernel) and waits on each before
the next. Kernel F's ``async`` entry (``csrc/row_gather.cu``) copies each
row into shared memory with ``cp.async`` at its run-time offset, with
``rg.DEFAULT_IN_FLIGHT`` rows in flight per CTA: the same function,
``x[cols]``.
Inputs as the reference makes them: x (1024, 256) f32 normal, 64 cols,
``default_rng(0)``. Prints whether the result equals the host's.

    python -m sgc_tpu_torch.scripts.exp_dma_gather_probe [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sgc_tpu_torch.ops import row_gather as rg
from sgc_tpu_torch.scripts import device_parser
from sgc_tpu_torch.utils.device import resolve_device

N, F, E = 1024, 256, 64   # table rows, features, rows gathered


def make_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The reference's ``(x, cols)``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, F)).astype(np.float32)
    cols = rng.integers(0, N, E).astype(np.int32)
    return x, cols


def run(x: torch.Tensor, cols: torch.Tensor,
        in_flight: int = rg.DEFAULT_IN_FLIGHT) -> dict:
    """One ``async`` gather, held against the host's ``x[cols]``
    exactly."""
    got = rg.row_gather(x, cols, "async", in_flight)
    ok = bool(torch.equal(got.cpu(), x.cpu()[cols.cpu().long()]))
    print("DMA gather probe: COMPILED, correct =", ok, flush=True)
    return {"correct": ok, "out": got}


def main(argv=None) -> int:
    a = device_parser(__doc__).parse_args(argv)
    dev = resolve_device(a.device)
    x, cols = make_inputs()
    out = run(torch.from_numpy(x).to(dev), torch.from_numpy(cols).to(dev))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
