"""Probe: does a block copy whose source block each CTA reads from an
index array run on this card (the counterpart of
scripts/exp_pallas_probe2.py, whose Pallas kernel reads the index through
a scalar-prefetch BlockSpec index map)?

8 blocks of 8 rows, 128 features (f32, ``arange * 1e-3``); ``sel`` a
``RandomState(0)`` permutation of the blocks; kernel E's
``select_blocks`` writes block ``i`` as 2 x block ``sel[i]``. Prints the
seconds to the first result and whether it equals the host's.

    python -m sgc_tpu_torch.scripts.exp_pallas_probe2 [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from sgc_tpu_torch.ops import probe_copy
from sgc_tpu_torch.scripts import backend, device_parser
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync

NB, B, F = 8, 8, 128   # blocks, rows a block, features


def make_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``x`` and ``sel`` on ``device``."""
    x = torch.arange(NB * B * F, dtype=torch.float32,
                     device=device).reshape(NB * B, F) * 1e-3
    sel = torch.as_tensor(np.random.RandomState(0).permutation(NB),
                          dtype=torch.int32, device=device)
    return x, sel


def run(x: torch.Tensor, sel: torch.Tensor, block: int = B) -> dict:
    """One ``select_blocks`` call, held against the host's copy of the
    same blocks (exact: doubling rounds nothing)."""
    print("backend:", backend(x.device), flush=True)
    t0 = time.perf_counter()
    y = probe_copy.select_blocks(x, sel, block)
    sync(x.device)
    dt = time.perf_counter() - t0
    xs = x.cpu().view(-1, block, x.shape[1])
    expect = (xs[sel.cpu().long()] * 2.0).reshape(-1, x.shape[1])
    ok = bool(torch.equal(y.cpu(), expect))
    print(f"per-CTA block index COMPILED in {dt:.1f}s, correct={ok}",
          flush=True)
    return {"seconds": dt, "correct": ok, "y": y}


def main(argv=None) -> int:
    a = device_parser(__doc__).parse_args(argv)
    out = run(*make_inputs(resolve_device(a.device)))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
