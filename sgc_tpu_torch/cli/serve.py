"""Serving CLI (the counterpart of sgc_tpu/cli/serve.py): load a trained
head and a feature store, expose the HTTP endpoint, on the card by
default.

    # artifacts first, e.g. save_params("model.npz", head) (either
    # package's) and np.save("feats.npy", propagated_features)
    python -m sgc_tpu_torch.cli.serve --params model.npz \\
        --features feats.npy --port 8787

POST /predict {"node_ids": [..]} returns argmax classes; /healthz reports
latency stats (p50/p99). See sgc_tpu_torch/serve/ for the engine.

``--bench`` measures the engine on the device instead of serving: a
Reddit-scale transductive store (232,965 x 602 f32, 41 classes), random
id batches swept over 1, 8, 64, 512 and ``--max_batch``, blocking and
pipelined, one JSON line with p50/p99 latency and rows/s per (variant,
batch) beside ``dispatch_floor_ms`` (a trivial launch closed by a sync):

    python -m sgc_tpu_torch.cli.serve --bench                # f32 + int8
    python -m sgc_tpu_torch.cli.serve --bench --variants f32,int8,inductive

The ``shard`` variant row-shards the store over every card of the
process (``EngineConfig.shard_store``; one shard on one card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from sgc_tpu_torch.models.sgc import SGC, init_sgc
from sgc_tpu_torch.serve.engine import EngineConfig, InferenceEngine, Stats
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync

VARIANTS = ("f32", "int8", "shard", "inductive")
BENCH_FEATURES, BENCH_CLASSES = 602, 41    # Reddit's widths


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _bench_variant(name: str, engine, batches, reps: int,
                   pipeline_depth: int = 2) -> list[dict]:
    """One row per batch size: ``reps`` random-id requests through
    ``predict_logits``, then the same requests through
    ``predict_logits_stream`` (latencies in ms, unrounded). Both passes
    keep their outputs, as a caller does: a pass that dropped them would
    reuse the freed host memory and skip the first-touch page faults that
    new result arrays pay, which can outweigh a whole transductive
    request."""
    rng = np.random.default_rng(0)
    n_nodes = engine._n_nodes
    out = []
    for b in batches:
        ids_list = [rng.integers(0, n_nodes, size=b) for _ in range(reps)]
        engine.predict_logits(ids_list[0])   # warm the bucket
        engine.stats = Stats()
        t0 = time.perf_counter()
        blocking = [engine.predict_logits(ids) for ids in ids_list]
        wall = time.perf_counter() - t0
        s = engine.stats
        row = {
            "variant": name,
            "batch": int(b),
            "requests": s.requests,
            "p50_ms": s.percentile_ms(50),
            "p99_ms": s.percentile_ms(99),
            "mean_ms": s.mean_latency_ms,
            "rows_per_s": int(s.rows / wall),
        }
        # the same batches pipelined: outputs equal the blocking path's
        # bit for bit in transductive mode (inductive samples afresh on
        # every call, so replaying the ids draws another tree)
        engine.stats = Stats()
        t0 = time.perf_counter()
        outs = list(engine.predict_logits_stream(ids_list,
                                                 depth=pipeline_depth))
        pwall = time.perf_counter() - t0
        ps = engine.stats
        row.update({
            "pipeline_depth": pipeline_depth,
            "rows_per_s_pipelined": int(ps.rows / pwall),
            "p50_ms_pipelined": ps.percentile_ms(50),
            "p99_ms_pipelined": ps.percentile_ms(99),
        })
        if engine._mode == "transductive":
            row["pipelined_bitwise_equal"] = all(
                np.array_equal(a, c) for a, c in zip(outs, blocking))
        log(f"  {name} batch={b}: p50 {row['p50_ms']:.4f}ms "
            f"p99 {row['p99_ms']:.4f}ms  {row['rows_per_s']} rows/s | "
            f"pipelined {row['rows_per_s_pipelined']} rows/s "
            f"(p50 {row['p50_ms_pipelined']:.4f}ms)")
        out.append(row)
    return out


def dispatch_floor_ms(device) -> float:
    """The least of three round trips of a trivial launch closed by a
    sync (after one warm call): the floor every request's latency sits
    on."""
    v = torch.ones((8, 128), device=device)
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        v.mul(2.0).add_(1.0)
        sync(device)
        times.append(time.perf_counter() - t0)
    return min(times[1:]) * 1e3


def bench_store(n: int, device) -> tuple[np.ndarray, SGC]:
    """The ``--bench`` store and head: ``n`` x 602 standard-normal f32
    features (seed 7) and a 41-class head (seed 0) on ``device``."""
    feats = np.random.default_rng(7).standard_normal(
        (n, BENCH_FEATURES)).astype(np.float32)
    params = init_sgc(torch.Generator().manual_seed(0), BENCH_FEATURES,
                      BENCH_CLASSES, bias=True, device=device)
    return feats, params


def run_bench(a, device=None) -> dict:
    """The ``--bench`` sweep on ``device`` (``None`` -> the card); prints
    and returns its JSON summary."""
    dev = resolve_device(device)
    variants = a.variants.split(",")
    bad = [v for v in variants if v not in VARIANTS]
    if bad:
        raise SystemExit(
            f"unknown --variants {bad}: expected a subset of "
            f"{sorted(VARIANTS)}")
    n, f, c = a.bench_nodes, BENCH_FEATURES, BENCH_CLASSES
    backend = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu")
    log(f"device: {backend}")
    log(f"store: {n} x {f} f32 ({n * f * 4 / 1e9:.2f} GB), {c} classes")
    feats, params = bench_store(n, dev)
    floor = dispatch_floor_ms(dev)

    batches = sorted({b for b in [1, 8, 64, 512, a.max_batch]
                      if b <= a.max_batch})
    results = []
    for name in variants:
        if name == "inductive":
            from sgc_tpu_torch.data.synthetic import synthetic_reddit

            log("variant inductive: building graph...")
            graph, raw, _, _ = synthetic_reddit(n / 232_965)
            engine = InferenceEngine(
                params, graph=graph, raw_features=raw,
                config=EngineConfig(max_batch=a.max_batch, warmup=False,
                                    fanouts=(25, 10)), device=dev)
        else:
            log(f"variant {name}: building engine...")
            engine = InferenceEngine(
                params, features=feats,
                config=EngineConfig(max_batch=a.max_batch,
                                    quantize_int8=(name == "int8"),
                                    shard_store=(name == "shard"),
                                    warmup=False), device=dev)
        results.extend(_bench_variant(name, engine, batches, a.reps,
                                      pipeline_depth=a.pipeline_depth))
        del engine

    top = max(batches)
    summary = {
        "metric": "serve_rows_per_s_max_batch",
        "value": max(r["rows_per_s"] for r in results if r["batch"] == top),
        "value_pipelined": max(r["rows_per_s_pipelined"] for r in results
                               if r["batch"] == top),
        "unit": "rows/s",
        "backend": backend,
        "dispatch_floor_ms": floor,
        "pipeline_depth": a.pipeline_depth,
        "store": {"nodes": n, "features": f, "classes": c},
        "results": results,
    }
    print(json.dumps(summary), flush=True)
    return summary


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--params", help="save_params artifact (.npz)")
    p.add_argument("--features", help=".npy of precomputed S^K X features")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max_batch", type=int, default=1024)
    p.add_argument("--bench", action="store_true",
                   help="measure the engine on the device (no server)")
    p.add_argument("--bench_nodes", type=int, default=232_965,
                   help="--bench store rows (default: Reddit scale)")
    p.add_argument("--variants", default="f32,int8",
                   help="--bench engine variants (f32,int8,shard,inductive)")
    p.add_argument("--reps", type=int, default=30,
                   help="--bench requests per (variant, batch)")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="--bench in-flight requests of the pipelined pass "
                        "(predict_logits_stream)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main() -> None:
    p = parser()
    a = p.parse_args()
    if a.bench:
        run_bench(a, device=a.device)
        return
    if not a.params or not a.features:
        p.error("--params and --features are required (or use --bench)")

    from sgc_tpu_torch.serve.http import serve
    from sgc_tpu_torch.utils.checkpoint import load_params

    params = load_params(a.params, device=a.device)
    feats = np.load(a.features)
    engine = InferenceEngine(params, features=feats,
                             config=EngineConfig(max_batch=a.max_batch),
                             device=a.device)
    server = serve(engine, host=a.host, port=a.port)
    host, port = server.server_address[:2]
    print(f"serving {feats.shape[0]} nodes on http://{host}:{port} "
          f"(mode={engine._mode})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
