"""Probe: does a hand-written CUDA kernel build and run on this card (the
counterpart of scripts/exp_pallas_probe.py)?

Builds kernel E (``csrc/probe_copy.cu``) when it is not built yet, then
launches it once on an (8, 128) f32 block, ``y = 2 x``, and prints the
build and launch seconds and ``y[0, 1]`` (2.0).

    python -m sgc_tpu_torch.scripts.exp_pallas_probe [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from sgc_tpu_torch.ops import kernels, probe_copy
from sgc_tpu_torch.scripts import backend, device_parser
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync


def run(device) -> dict:
    """Build (on a card) and launch kernel E once; raises unless
    ``y[0, 1] == 2.0``."""
    dev = torch.device(device)
    print("backend:", backend(dev), flush=True)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        kernels.entry("probe_copy", "probe_scale2")
    build_s = time.perf_counter() - t0
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=dev).reshape(8, 128)
    t1 = time.perf_counter()
    y = probe_copy.scale2(x)
    sync(dev)
    launch_s = time.perf_counter() - t1
    got = float(y[0, 1])
    print(f"compiled kernel OK in {time.perf_counter() - t0:.1f}s (build "
          f"{build_s:.1f}s, launch {launch_s * 1e3:.3f} ms), y[0,1]={got}",
          flush=True)
    if got != 2.0:
        raise AssertionError(f"y[0, 1] = {got}, expected 2.0")
    return {"build_s": build_s, "launch_s": launch_s, "x": x, "y": y}


def main(argv=None) -> int:
    a = device_parser(__doc__).parse_args(argv)
    run(resolve_device(a.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
