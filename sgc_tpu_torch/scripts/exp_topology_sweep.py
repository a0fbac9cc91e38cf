"""Topology sweep on the card (the counterpart of
scripts/exp_topology_sweep.py): does ``formulation="auto"`` lose to the
segment path on some topology?

The grid is the reference's: clustered Reddit-shaped graphs at intra
fraction 0.5 / 0.65 / 0.85 x 10 / 50 / 200 communities with a squared
degree tail, two power-law tails, and ``synthetic_reddit``'s structureless
uniform graph (``--quick``: the three corners and the uniform graph). On
each it times, best of two runs after a warm one, each closed by a sync:

* two segment hops (kernel B), the last on the train-row subgraph (the
  reference's uniform-leg program), the graphs placed once;
* ``LocalityPlan.build(formulation="auto", calibrate=True)``'s two hops
  (on the card: kernels A + B at the admission measured there).

A config passes when auto <= segment * (1 + MARGIN); ``main`` exits 1 if
any fails, as the reference does. Each row adds, as extra fields that
enter neither ``pass`` nor the exit code, the uncalibrated ``auto`` plan's
hops (``calibrate=False``: the committed TPU admission rates) and the
``onehot`` plan's hops (kernel C + kernel B), as the bench's ``forms``
block does, and every time unrounded in ms.

One JSON line a config on stdout, a summary on stderr.

    python -m sgc_tpu_torch.scripts.exp_topology_sweep [--scale 0.25]
        [--quick] [--device cuda|cpu]
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
from sgc_tpu_torch.graph.locality import LocalityPlan
from sgc_tpu_torch.ops.spmm import spmm_segment
from sgc_tpu_torch.scripts import backend, best_seconds, device_parser, log
from sgc_tpu_torch.utils.device import resolve_device

MARGIN = 0.15
REPS = 2
INTRAS = (0.5, 0.65, 0.85)
COMMUNITIES = (10, 50, 200)
POWERLAW = ((0.85, 50), (0.5, 200))
QUICK = ((0.5, 200, "sq"), (0.85, 50, "sq"), (0.85, 50, "powerlaw"))
UNIFORM = "uniform_structureless"


def grid(quick: bool = False) -> list:
    """``[(name, keywords of synthetic_reddit_clustered or None for the
    uniform graph)]`` in the reference's order."""
    if quick:
        combos = list(QUICK)
    else:
        combos = [(i, c, "sq") for i in INTRAS for c in COMMUNITIES]
        combos += [(i, c, "powerlaw") for i, c in POWERLAW]
    out = [(f"intra{i}_comm{c}_{tail}",
            dict(intra=i, communities=c, tail=tail))
           for i, c, tail in combos]
    return out + [(UNIFORM, None)]


def make_data(kw: dict | None, scale: float):
    """A config's ``(graph, features, labels, idx_train)`` on the host."""
    if kw is None:
        return synthetic_reddit(scale)
    return synthetic_reddit_clustered(scale, shuffle=True, **kw)


def time_segment(graph, graph_final, x, reps: int = REPS):
    """``(best seconds, out)`` of two kernel-B hops, the last on
    ``graph_final``, both graphs placed on x's device once."""
    g1, g2 = graph.to(x.device), graph_final.to(x.device)
    return best_seconds(lambda: spmm_segment(g2, spmm_segment(g1, x)), reps)


def time_plan(plan, reps: int = REPS):
    """``(best seconds, out)`` of the plan's ``khop_traceable(degree=2)``
    on its own features."""
    khop, dargs = plan.khop_traceable(degree=2)
    x = torch.as_tensor(plan.features, device=plan.device)
    return best_seconds(lambda: khop(x, dargs), reps)


def run_config(name: str, data, device, reps: int = REPS) -> dict:
    """One config: ``{"row": the line's fields, "plans": {form: plan},
    "outputs": {form: propagated train rows}, "segment": (graph,
    graph_final, x)}``."""
    graph, features, labels, idx_train = data
    x = torch.as_tensor(features, device=device)
    graph_final = graph.row_subgraph(idx_train)
    seg_s, seg_out = time_segment(graph, graph_final, x, reps)

    t0 = time.perf_counter()
    plan = LocalityPlan.build(graph, features, labels, idx_train,
                              formulation="auto", calibrate=True,
                              device=device)
    plan_s = time.perf_counter() - t0
    auto_s, auto_out = time_plan(plan, reps)
    plans = {"auto": plan,
             "auto_uncal": LocalityPlan.build(
                 graph, features, labels, idx_train, formulation="auto",
                 calibrate=False, device=device),
             "onehot": LocalityPlan.build(
                 graph, features, labels, idx_train, formulation="onehot",
                 device=device)}
    uncal_s, uncal_out = time_plan(plans["auto_uncal"], reps)
    onehot_s, onehot_out = time_plan(plans["onehot"], reps)

    row = {
        "config": name,
        "nnz": graph.nnz,
        "segment_s": round(seg_s, 4),
        "auto_s": round(auto_s, 4),
        "ratio": round(auto_s / seg_s, 3),
        "formulation": plan.formulation,
        "dense_frac": round(plan.dense_fraction, 3),
        "plan_build_s": round(plan_s, 1),
        "pass": auto_s <= seg_s * (1 + MARGIN),
        "segment_ms": seg_s * 1e3,
        "auto_ms": auto_s * 1e3,
        "auto_uncal_ms": uncal_s * 1e3,
        "auto_uncal_formulation": plans["auto_uncal"].formulation,
        "auto_uncal_dense_frac": plans["auto_uncal"].dense_fraction,
        "onehot_ms": onehot_s * 1e3,
        "onehot_dense_frac": plans["onehot"].dense_fraction,
        "auto_dense_frac": plan.dense_fraction,
    }
    return {"row": row, "plans": plans,
            "outputs": {"segment": seg_out, "auto": auto_out,
                        "auto_uncal": uncal_out, "onehot": onehot_out},
            "segment": (graph, graph_final, x)}


def run(scale: float, device, quick: bool = False, reps: int = REPS,
        on_config=None) -> list:
    """Every config of :func:`grid` at ``scale``: prints its line and logs
    its verdict; ``on_config(result)`` sees each :func:`run_config` result
    before the next config is built. Returns the rows."""
    dev = resolve_device(device)
    rows = []
    for name, kw in grid(quick):
        log(f"building {name}...")
        result = run_config(name, make_data(kw, scale), dev, reps)
        row = result["row"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        log(f"{name:34s} seg {row['segment_ms'] / 1e3:.3f}s  auto "
            f"{row['auto_ms'] / 1e3:.3f}s ({row['formulation']}, dense "
            f"{row['auto_dense_frac']:.2f}) "
            f"{'PASS' if row['pass'] else 'FAIL'}")
        if on_config is not None:
            on_config(result)
    return rows


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--scale", type=float, default=0.25)
    p.add_argument("--quick", action="store_true",
                   help="3-config smoke (corners only)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    log(f"backend: {backend(dev)}  scale {a.scale}")
    rows = run(a.scale, dev, a.quick)
    n_fail = sum(not r["pass"] for r in rows)
    log(f"\n{len(rows) - n_fail}/{len(rows)} configs pass "
        f"(auto <= segment * {1 + MARGIN})")
    if n_fail:
        log("FAILING: " + ", ".join(r["config"] for r in rows
                                    if not r["pass"]))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
