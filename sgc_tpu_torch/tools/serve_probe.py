#!/usr/bin/env python3
"""Where a transductive serving request's time goes, on one card, over
the ``cli.serve --bench`` store (232,965 x 602 f32, 41 classes, uniform
random ids):

    python3 -m sgc_tpu_torch.tools.serve_probe [--batches 64,512,1024]
        [--reps 30] [--rounds 2]

* ``outputs``: per batch, ms per request of the blocking pass
  (``predict_logits``) and the pipelined one (``predict_logits_stream``,
  depth 2), each once dropping every response and once keeping them all
  alive, in turns for ``--rounds`` rounds. A kept response is a fresh
  host array, whose first-touch page faults a dropping pass skips by
  reusing freed memory.
* ``profile``: one blocking and one pipelined pass at the largest batch
  under ``torch.profiler``: the wall, the device's self time summed over
  its kernels and copies, their ratio (the device's busy share while
  profiled), and the host's top operations by self time.

Prints the card's name and power limit, then one JSON line per probe.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def output_cost(engine, n_nodes: int, batch: int, reps: int,
                rng: np.random.Generator) -> dict:
    """ms per request of each pass, dropping or keeping the responses."""
    ids_list = [rng.integers(0, n_nodes, batch) for _ in range(reps)]
    engine.predict_logits(ids_list[0])

    def blocking_drop():
        for ids in ids_list:
            engine.predict_logits(ids)

    def stream_drop():
        for _ in engine.predict_logits_stream(ids_list, depth=2):
            pass

    passes = {
        "blocking_drop": blocking_drop,
        "blocking_keep": lambda: [engine.predict_logits(i)
                                  for i in ids_list],
        "pipelined_drop": stream_drop,
        "pipelined_keep": lambda: list(engine.predict_logits_stream(
            ids_list, depth=2)),
    }
    out = {}
    for name, run in passes.items():
        t0 = time.perf_counter()
        kept = run()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
        del kept
    return out


def profile_pass(engine, ids_list, pipelined: bool) -> dict:
    """One pass under ``torch.profiler``: wall, device self time, busy
    share and the host's top operations."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if pipelined:
            kept = list(engine.predict_logits_stream(ids_list, depth=2))
        else:
            kept = [engine.predict_logits(i) for i in ids_list]
        wall_ms = (time.perf_counter() - t0) * 1e3
    del kept
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "host_top_ms": {e.key: e.self_cpu_time_total / 1e3
                            for e in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="64,512,1024")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from sgc_tpu_torch.cli.serve import bench_store
    from sgc_tpu_torch.serve import InferenceEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    n = 232_965
    feats, params = bench_store(n, device)
    engine = InferenceEngine(params, features=feats, device=device)
    rng = np.random.default_rng(0)
    batches = [int(b) for b in args.batches.split(",")]
    for r in range(args.rounds):
        for b in batches:
            print(json.dumps({"probe": "outputs", "round": r, "batch": b,
                              "ms_per_request": output_cost(
                                  engine, n, b, args.reps, rng)}),
                  flush=True)
    ids_list = [rng.integers(0, n, max(batches)) for _ in range(args.reps)]
    list(engine.predict_logits_stream(ids_list[:4], depth=2))
    for pipelined in (False, True):
        print(json.dumps({"probe": "profile", "batch": max(batches),
                          "pipelined": pipelined,
                          **profile_pass(engine, ids_list, pipelined)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
