"""Kernel A's cell order (the counterpart of scripts/exp_super_rows.py).

The reference's super-row kernel kept an S-row-block output panel in TPU
VMEM and ordered the cells (rb // S, st, rb), so that a stripe of x shared
by a panel's row blocks was loaded once per (panel, stripe). This script
times the dense term alone, kernel A (``ops/spmm_blockdense.py::
apply_cells``) at ``"bf16"`` (the reference's default), on the main split
of the headline's plan (the clustered graph at ``SGC_SUPER_SCALE``,
default 1.0, shuffled, ``LocalityPlan.build(formulation="blockdense",
calibrate=True)``), rebuilt in each order at the plan's admission: (rb,
st), ``super_rows`` S for each S in ``SGC_SUPER_S`` (default "4,8,16"),
and the grouped layouts S8G2 and S8G4 (zero hole cells pad each (panel,
stripe) run to G). Each time is the best of 3 runs after a warm one,
closed by a sync. Beside each it prints ``stripe_loads``, the reference's
host count of stripe fetches in its kernel's cell order (the runs of
equal (panel, stripe) in slot order): a property of the TPU kernel's
pipeline. Kernel A walks each row block's cells through its own index in
any order, so on the card the order moves only the cells' memory layout.

The reference calls ``utils.alloc.prewarm_pool`` first; the port leaves
that module out (ROADMAP queue 1), so the call is dropped.

On the H100 the calibrated admission admits no cell (ROADMAP queue 3 item
1), so ``main`` raises there, as ``exp_dense_term``'s does; :func:`run`
takes any plan, and ``chip_smoke.py`` drives it on the main path's plan
(the committed admission).

    python -m sgc_tpu_torch.scripts.exp_super_rows [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
from sgc_tpu_torch.graph.locality import LocalityPlan
from sgc_tpu_torch.ops import spmm_blockdense as bd
from sgc_tpu_torch.scripts import backend, best_seconds, device_parser, log
from sgc_tpu_torch.utils.device import resolve_device

REPS = 3
GROUPED = ((8, 2), (8, 4))


def stripe_loads(rb: np.ndarray, st: np.ndarray, S: int | None) -> int:
    """The reference's count: stripe fetches are the runs of consecutive
    equal (panel, stripe) keys in the kernel's cell order."""
    if S is None:
        key = rb.astype(np.int64) * (int(st.max()) + 1) + st
    else:
        key = (rb // S).astype(np.int64) * (int(st.max()) + 1) + st
    return int(1 + (np.diff(key) != 0).sum())


def variants(super_rows=(4, 8, 16)) -> list:
    """``[(name, split_block_dense keywords)]`` in the reference's
    order."""
    out = [("None", {})]
    out += [(f"S{S}", dict(super_rows=S)) for S in super_rows]
    out += [(f"S{S}G{G}", dict(super_rows=S, group_cells=G))
            for S, G in GROUPED]
    return out


def variant_split(plan, kw: dict, n_features: int):
    """The plan's main split in one order (``kw`` of :func:`variants`),
    dense cells only (the remainder dropped, as the reference times the
    dense term alone)."""
    base = plan.split_main
    full = bd.split_block_dense(plan.graph, n_features, base.row_block,
                                base.stripe, min_edges=base.min_edges, **kw)
    return dataclasses.replace(full, rest=None, sparse_edges=0)


def run(plan, x, super_rows=(4, 8, 16), precision: str = "bf16",
        reps: int = REPS, on_variant=None) -> dict:
    """Every order on ``plan``'s main split with placed ``x``;
    ``on_variant(name, split, args)`` sees each placed split. Prints and
    returns the reference's JSON (``dense_ms`` and the rest per order)
    with the port's keys."""
    if plan.split_main.n_cells == 0:
        raise ValueError("the plan's main split has no dense cell")
    F = int(x.shape[1])
    rows = {}
    for name, kw in variants(super_rows):
        split = variant_split(plan, kw, F)
        loads = stripe_loads(split.rb_ids[: split.n_cells],
                             split.st_ids[: split.n_cells],
                             kw.get("super_rows"))
        t0 = time.perf_counter()
        args = bd.blockdense_device_args(split, x.device)
        log(f"{name}: stripe loads {loads} (vs {split.n_cells} cells, "
            f"{split.cells.shape[0]} slots); placed in "
            f"{time.perf_counter() - t0:.1f}s")
        if on_variant is not None:
            on_variant(name, split, args)
        best, _ = best_seconds(
            lambda: bd.apply_cells(split, args, x, precision), reps)
        rows[name] = {"dense_ms": round(best * 1e3, 1),
                      "stripe_loads": loads,
                      "n_cells": split.n_cells,
                      "n_slots": int(split.cells.shape[0]),
                      "cell_gb": round(split.cells.nbytes / 1e9, 2),
                      "ms": best * 1e3}
        log(f"  dense term {best * 1e3:.3f} ms")
        del args, split
    base_ms = rows["None"]["ms"]
    best_s = min(rows, key=lambda k: rows[k]["ms"])
    out = {"scale": None, "rows": rows, "best": best_s,
           "speedup_vs_classic": round(base_ms / rows[best_s]["ms"], 3),
           "precision": precision, "device": backend(x.device)}
    return out


def main(argv=None) -> int:
    a = device_parser(__doc__).parse_args(argv)
    dev = resolve_device(a.device)
    scale = float(os.environ.get("SGC_SUPER_SCALE", "1.0"))
    supers = tuple(int(s) for s in os.environ.get(
        "SGC_SUPER_S", "4,8,16").split(",") if s)
    log(f"backend {backend(dev)}; scale {scale}")
    graph, features, labels, idx_train = synthetic_reddit_clustered(
        scale, shuffle=True)
    plan = LocalityPlan.build(graph, features, labels, idx_train,
                              formulation="blockdense", calibrate=True,
                              device=dev)
    base = plan.split_main
    log(f"plan: cells {base.n_cells} dense_frac {plan.dense_fraction:.3f}")
    if base.n_cells == 0:
        raise RuntimeError(
            "the calibrated split admits no dense cell on this device "
            "(ROADMAP queue 3 item 1): the measured rates need "
            f"{base.min_edges:.0f} edges a cell; run() takes any plan")
    out = run(plan, torch.as_tensor(plan.features, device=dev), supers)
    out["scale"] = scale
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
