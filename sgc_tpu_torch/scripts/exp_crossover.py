"""Segment against flat kernel C: the crossover curve (the counterpart of
scripts/exp_crossover.py).

At each of ``--scales`` of the synthetic Reddit graph (``--topology``
uniform, or clustered), one JSON line per implementation:

* ``segment``: kernel B over the whole graph (the reference's ``xla``
  line, the baseline every ``vs_xla`` ratio divides);
* ``tiled_flat_f32`` and ``tiled_flat_bf16``: kernel C's flat entry
  (``ops/spmm_tiled.py::spmm_tiled_flat``, the counterpart of
  ``spmm_pallas_flat``) on the graph tiled at the reference's
  ``pick_tiles`` with 1,024-slot chunks, at both precisions. The
  reference's feature tile (256) has no counterpart: kernel C holds a
  row's features in one warp, so the reference's one timing per
  precision stays one timing;
* ``hybrid`` at (512, 512) and (1024, 1024): ``split_dense_cells`` (the
  reference's admission) then ``spmm_hybrid_split`` (kernel C on the
  dense cells, kernel B on the remainder).

Each time is the mean of ``--repeats`` runs after a warm one, closed by
a sync; ``rel_err`` is the max error against the segment product over
its max. The lines keep the reference's keys (``vs_xla`` is the segment
time over this one) and add ``ms`` unrounded. Every kernel call is a
plain call: where the reference printed a TPU compile failure as a data
point, a failure here raises.

    python -m sgc_tpu_torch.scripts.exp_crossover [--scales 0.05,0.1,0.25,0.5]
        [--topology uniform|clustered] [--repeats 5] [--json out.jsonl]
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from sgc_tpu_torch.data.synthetic import (
    synthetic_reddit,
    synthetic_reddit_clustered,
)
from sgc_tpu_torch.ops.spmm import spmm_segment
from sgc_tpu_torch.ops.spmm_hybrid import (
    hybrid_device_args,
    split_dense_cells,
    spmm_hybrid_split,
)
from sgc_tpu_torch.ops.spmm_tiled import (
    spmm_tiled_flat,
    tile_graph,
    tiled_device_args,
)
from sgc_tpu_torch.scripts import backend, device_parser
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync

CHUNK = 1024
PRECISIONS = ("f32", "bf16")
HYBRID_TILES = ((512, 512), (1024, 1024))


def pick_tiles(n_nodes: int) -> tuple[int, int]:
    """The reference's: coarser cells at larger node counts keep the chunk
    padding bounded."""
    if n_nodes <= 80_000:
        return 1024, 1024
    return 2048, 2048


def mean_seconds(fn, repeats: int, device) -> tuple[float, torch.Tensor]:
    """The reference's timing: one warm call, then the mean of
    ``repeats`` calls closed by one sync."""
    out = fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    sync(device)
    return (time.perf_counter() - t0) / repeats, out


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max()) / max(1e-9, float(ref.abs().max()))


def make_data(scale: float, topology: str):
    if topology == "clustered":
        return synthetic_reddit_clustered(scale)
    return synthetic_reddit(scale)


def run_scale(scale: float, topology: str, device, repeats: int = 5,
              emit=None) -> dict:
    """Every line at one scale: ``{"rows": [...], "graph": the placed
    graph, "x", "ref": the segment product, "tiled": (layout, args),
    "hybrid": {(rb, w): (split, args)}}``."""
    emit = emit or (lambda row: print(json.dumps(row), flush=True))
    graph, x_host, _, _ = make_data(scale, topology)
    n, f = x_host.shape
    e = graph.nnz
    x = torch.as_tensor(x_host, device=device)
    g = graph.to(device)
    xla_s, ref = mean_seconds(lambda: spmm_segment(g, x), repeats, device)
    rows = [{"scale": scale, "topology": topology, "impl": "segment",
             "nodes": n, "edges": e, "s": round(xla_s, 4),
             "medges_per_s": round(e / xla_s / 1e6, 1), "ms": xla_s * 1e3}]
    emit(rows[-1])

    rb, w = pick_tiles(n)
    t0 = time.perf_counter()
    tiled = tile_graph(graph, rb, w, CHUNK)
    tile_s = time.perf_counter() - t0
    targs = tiled_device_args(tiled, device)
    pad = tiled.rows.shape[0] / max(1, e)
    for prec in PRECISIONS:
        dt, y = mean_seconds(
            lambda p=prec: spmm_tiled_flat(tiled, x, targs, p), repeats,
            device)
        rows.append({"scale": scale, "topology": topology,
                     "impl": f"tiled_flat_{prec}", "rb": rb, "w": w,
                     "pad": round(pad, 3), "tile_s": round(tile_s, 2),
                     "s": round(dt, 4), "vs_xla": round(xla_s / dt, 3),
                     "medges_per_s": round(e / dt / 1e6, 1),
                     "rel_err": float(f"{rel_err(y, ref):.2e}"),
                     "ms": dt * 1e3})
        emit(rows[-1])

    hybrid = {}
    for hrb, hw in HYBRID_TILES:
        t0 = time.perf_counter()
        split = split_dense_cells(graph, f, hrb, hw, CHUNK)
        split_s = time.perf_counter() - t0
        hargs = hybrid_device_args(split, device)
        dt, y = mean_seconds(lambda s=split, a=hargs: spmm_hybrid_split(
            s, x, a), repeats, device)
        rows.append({"scale": scale, "topology": topology, "impl": "hybrid",
                     "rb": hrb, "w": hw,
                     "dense_frac": round(split.dense_edges / max(1, e), 3),
                     "pad": round(split.pad, 3),
                     "split_s": round(split_s, 2),
                     "s": round(dt, 4), "vs_xla": round(xla_s / dt, 3),
                     "medges_per_s": round(e / dt / 1e6, 1),
                     "rel_err": float(f"{rel_err(y, ref):.2e}"),
                     "ms": dt * 1e3})
        emit(rows[-1])
        hybrid[(hrb, hw)] = (split, hargs)
    return {"rows": rows, "graph": g, "x": x, "ref": ref,
            "tiled": (tiled, targs), "hybrid": hybrid}


def run(scales, topology: str, device, repeats: int = 5,
        json_path: str | None = None, on_scale=None) -> list:
    """Every scale in turn; lines also appended to ``json_path``;
    ``on_scale(result)`` sees each :func:`run_scale` result. Returns the
    rows."""
    out_f = open(json_path, "a") if json_path else None

    def emit(row):
        print(json.dumps(row), flush=True)
        if out_f:
            out_f.write(json.dumps(row) + "\n")
            out_f.flush()

    rows = []
    try:
        for scale in scales:
            result = run_scale(scale, topology, device, repeats, emit)
            rows.extend(result["rows"])
            if on_scale is not None:
                on_scale(result)
    finally:
        if out_f:
            out_f.close()
    return rows


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--scales", default="0.05,0.1,0.25,0.5")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--topology", default="uniform",
                   choices=["uniform", "clustered"])
    p.add_argument("--json", default=None)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    print("backend:", backend(dev), flush=True)
    run([float(s) for s in a.scales.split(",")], a.topology, dev,
        a.repeats, a.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
