"""Tile sweep of flat kernel C (the counterpart of
scripts/exp_flat_sweep.py).

On the synthetic Reddit graph at ``--scale``, kernel B (the segment
baseline, the reference's ``xla_segment_s``) and then kernel C's flat
entry (``ops/spmm_tiled.py::spmm_tiled_flat``) over the reference's grid,
(R, W) in {512, 1024, 2048} x {1024, 2048} with 1,024-slot chunks at
``"f32"``: one JSON line a tiling with its time, ``vs_xla`` (the segment
time over it), the chunk padding and the error against the segment
product; then "BEST:" and the best tiling again at ``"bf16"``. Each time
is the mean of ``--repeats`` runs after a warm one, closed by a sync; the
lines add ``ms`` unrounded.

The reference's feature tile (256) has no counterpart: kernel C holds a
row's features in one warp, so each tiling is one timing. Every kernel
call is a plain call: where the reference printed a TPU compile failure
as a data point, a failure here raises.

    python -m sgc_tpu_torch.scripts.exp_flat_sweep [--scale 0.1]
        [--repeats 3] [--json out.jsonl] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys

import torch

from sgc_tpu_torch.data.synthetic import synthetic_reddit
from sgc_tpu_torch.ops.spmm import spmm_segment
from sgc_tpu_torch.ops.spmm_tiled import (
    spmm_tiled_flat,
    tile_graph,
    tiled_device_args,
)
from sgc_tpu_torch.scripts import backend, device_parser
from sgc_tpu_torch.scripts.exp_crossover import mean_seconds, rel_err
from sgc_tpu_torch.utils.device import resolve_device

CHUNK = 1024
CONFIGS = tuple((rb, w, CHUNK, "f32") for rb in (512, 1024, 2048)
                for w in (1024, 2048))


def run(graph, x: torch.Tensor, repeats: int = 3,
        json_path: str | None = None, on_tiling=None) -> dict:
    """The sweep on a host ``graph`` and placed ``x``; ``on_tiling(tiled,
    args)`` sees each layout placed. Returns ``{"xla_s", "ref", "rows",
    "best", "bf16"}``."""
    dev = x.device
    n, f = x.shape
    e = int(graph.rows.shape[0])
    print(f"backend={backend(dev)} nodes={n} edges={e} f={f}", flush=True)
    g = graph.to(dev)
    xla_s, ref = mean_seconds(lambda: spmm_segment(g, x), repeats, dev)
    print(f"xla_segment_s={xla_s:.4f} ({e / xla_s / 1e6:.1f}M edges/s)",
          flush=True)
    out_f = open(json_path, "a") if json_path else None
    rows, layouts = [], {}
    try:
        for rb, w, c, prec in CONFIGS:
            tiled = tile_graph(graph, rb, w, c)
            targs = tiled_device_args(tiled, dev)
            layouts[(rb, w, c)] = (tiled, targs)
            if on_tiling is not None:
                on_tiling(tiled, targs)
            dt, y = mean_seconds(
                lambda: spmm_tiled_flat(tiled, x, targs, prec), repeats, dev)
            pad = tiled.rows.shape[0] / max(1, e)
            row = {"rb": rb, "w": w, "c": c, "prec": prec,
                   "pallas_s": round(dt, 4), "vs_xla": round(xla_s / dt, 3),
                   "pad": round(pad, 3),
                   "rel_err": float(f"{rel_err(y, ref):.2e}"),
                   "ms": dt * 1e3}
            print(json.dumps(row), flush=True)
            rows.append(row)
            if out_f:
                out_f.write(json.dumps(row) + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
    best = min(rows, key=lambda r: r["pallas_s"])
    print("BEST:", json.dumps(best), flush=True)
    tiled, targs = layouts[(best["rb"], best["w"], best["c"])]
    dt, y = mean_seconds(lambda: spmm_tiled_flat(tiled, x, targs, "bf16"),
                         repeats, dev)
    bf16 = {**{k: best[k] for k in ("rb", "w", "c")}, "prec": "bf16",
            "pallas_s": round(dt, 4), "vs_xla": round(xla_s / dt, 3),
            "rel_err": float(f"{rel_err(y, ref):.2e}"), "ms": dt * 1e3}
    print(json.dumps(bf16), flush=True)
    return {"xla_s": xla_s, "ref": ref, "rows": rows, "best": best,
            "bf16": bf16}


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--json", default=None)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    graph, x, _, _ = synthetic_reddit(a.scale)
    run(graph, torch.as_tensor(x, device=dev), a.repeats, a.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
