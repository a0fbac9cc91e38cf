"""(row block, stripe, feature tile) sweep of the hybrid hop on the
clustered graph (the counterpart of scripts/exp_hybrid_sweep.py).

The headline's graph (``synthetic_reddit_clustered`` at
``SGC_BENCH_SCALE``, default 1.0, shuffled) in LPA order, then for each
of the reference's six ``CONFIGS`` the split by cell fill
(``split_dense_cells`` at its uncalibrated ``min_fill``), rebuilt per
(R, W) since the threshold moves, and one hop of ``spmm_hybrid_split``
(kernel C on the dense cells, kernel B on the remainder), the best of 4
runs after a warm one, closed by a sync. One JSON line a config, then
"BEST:".

The reference's third axis, the feature tile, has no counterpart: kernel
C holds a row's features in one warp. So configs that differ only in
``ft`` are one function: each line keeps its ``ft`` and the port times
each (R, W) split once (the line's ``same_as`` names the config whose
timing it repeats). The reference's ``hybrid_bind`` is left out (ROADMAP
queue 1): each split is placed once (``hybrid_device_args``). Every
kernel call is a plain call: where the reference printed a failure as a
data point, a failure here raises.

    SGC_BENCH_SCALE=1.0 python -m sgc_tpu_torch.scripts.exp_hybrid_sweep
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
from sgc_tpu_torch.graph.reorder import apply_order, lpa_order
from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops.spmm_hybrid import (
    hybrid_device_args,
    split_dense_cells,
    spmm_hybrid_split,
)
from sgc_tpu_torch.scripts import backend, best_seconds, device_parser
from sgc_tpu_torch.utils.device import resolve_device

# (row_block, stripe, feature_tile): the reference's six configs
CONFIGS = (
    (512, 512, 256),
    (512, 512, 128),
    (256, 256, 128),
    (256, 512, 128),
    (512, 256, 128),
    (1024, 1024, 128),
)
REPS = 4


def lpa_graph(scale: float):
    """The clustered graph at ``scale`` in LPA order: ``(graph, features)``
    on the host."""
    graph, feats, _, _ = synthetic_reddit_clustered(scale, shuffle=True)
    nnz = graph.nnz
    adj = sp.coo_matrix(
        (host(graph.vals)[:nnz],
         (host(graph.rows)[:nnz], host(graph.cols)[:nnz])),
        shape=graph.shape).tocsr()
    order = lpa_order(adj)
    adj_p, feats_p = apply_order(adj, order, feats)
    return SparseGraph.from_scipy(adj_p.tocoo()), np.asarray(feats_p)


def run(graph, x: torch.Tensor, reps: int = REPS, on_split=None) -> list:
    """The sweep on a host ``graph`` (LPA order) and placed ``x``;
    ``on_split(split, args)`` sees each split placed. Returns the
    rows."""
    dev = x.device
    nf = int(x.shape[1])
    print(f"graph ready: {graph.nnz} edges, F={nf}", flush=True)
    results, timed = [], {}
    for rb, w, ft in CONFIGS:
        t0 = time.perf_counter()
        split = split_dense_cells(graph, nf, rb, w)
        split_s = time.perf_counter() - t0
        row = {"rb": rb, "w": w, "ft": ft,
               "dense_frac": round(split.dense_edges / graph.nnz, 3),
               "pad": round(split.pad, 3),
               "min_fill": round(split.min_fill, 4),
               "split_s": round(split_s, 1)}
        if (rb, w) in timed:
            first = timed[(rb, w)]
            row.update({k: first[k] for k in ("hop_s", "edges_per_s_M",
                                              "hop_ms")},
                       same_as=[first["rb"], first["w"], first["ft"]])
        else:
            args = hybrid_device_args(split, dev)
            if on_split is not None:
                on_split(split, args)
            best, _ = best_seconds(lambda: spmm_hybrid_split(split, x, args),
                                   reps)
            row["hop_s"] = round(best, 4)
            row["edges_per_s_M"] = round(graph.nnz / best / 1e6, 1)
            row["hop_ms"] = best * 1e3
            timed[(rb, w)] = row
            del args
        print(json.dumps(row), flush=True)
        results.append(row)
    print("BEST:", json.dumps(min(results, key=lambda r: r["hop_s"])),
          flush=True)
    return results


def main(argv=None) -> int:
    a = device_parser(__doc__).parse_args(argv)
    dev = resolve_device(a.device)
    print("backend:", backend(dev), flush=True)
    graph, feats = lpa_graph(float(os.environ.get("SGC_BENCH_SCALE", "1.0")))
    run(graph, torch.as_tensor(feats, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
