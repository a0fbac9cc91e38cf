"""Headline benchmark of the port (the counterpart of bench.py):
Reddit-scale SGC, the K = 2 precompute and the linear head, on the card.

    python -m sgc_tpu_torch.bench [--device cuda|cpu]

Baseline: the reference trains SGC on Reddit (233K nodes, ~11.6M
undirected edges) in 2.7 s on a GTX 1080 Ti, two cuSPARSE SpMM hops and
2 LBFGS epochs (the SGC paper's README). ``vs_baseline > 1`` means
faster than that GPU figure.

If the real Reddit npz pair is present (``SGC_TPU_DATA`` or ``./data``,
``utils/paths.py``) and the scale is 1.0, the bench uses it; otherwise it
builds the synthetic stand-ins at Reddit's dimensions (232,965 nodes,
~11.6M edges, 602 features, 41 classes, 152,410 train rows).

Legs, as in the reference:

* clustered (the headline ``value``): 50 communities holding 85% of the
  edges, node ids shuffled; ``LocalityPlan.build(formulation,
  calibrate=True)`` discovers the communities (LPA) and admits cells by
  the rates measured on the device, then 2 hops and the head (8 Newton
  steps; ``SGC_BENCH_TRAINER=lbfgs`` for 2 LBFGS epochs), the per-term
  roofline and the Newton-vs-LBFGS parity gate;
* uniform segment: squared-uniform column skew, kernel B over the whole
  graph, then over the train rows (``row_subgraph``), 2 LBFGS epochs;
* uniform auto: the clustered leg's pipeline on the uniform data.

The port adds one block, ``forms``, on the clustered leg's data: the
committed admission (``calibrate=False``) under ``blockdense_kernel``
(kernels A + B) and ``onehot`` (kernels C + B), each with its own timing,
roofline (block-dense) and parity gate, so the three hop forms are
reported side by side.

Each timed region gets one warm run first (kernel builds, the admission
probe and the placement of the plan's arrays fall there) and is closed
by a synchronize of the device. Each leg's kernel launches are counted
(counters zeroed just before the leg, read just after).

Host-only after the legs: the 8-part communication model, the 8-part
sharded block-dense plan (``device=False``) and the device-count x
fabric sweep. Their fabric figures are the reference's TPU v5e
constants, kept for parity (``fabric_note`` in the sidecar).

Prints ONE compact JSON line (at most ``COMPACT_MAX_CHARS``); the full
detail goes to ``build/bench_details_torch.json``. Any failure ends the
run with a non-zero exit, and so does a parity gate that fails (after
the line and the sidecar are written).

Env: ``SGC_BENCH_SCALE`` (default 1.0) shrinks the synthetic problem;
``SGC_BENCH_TOPOLOGY=both|clustered|uniform`` (default both);
``SGC_BENCH_FORMULATION=auto|blockdense|blockdense_kernel|onehot``
(default auto; the reference's ``blockdense_pallas`` names
``blockdense_kernel``); ``SGC_BENCH_TRAINER=newton|lbfgs``;
``SGC_BENCH_PROFILE_PLAN`` samples the host during the plan builds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the reference's Reddit shape, under its names
from sgc_tpu_torch.data.synthetic import (  # noqa: F401
    REDDIT_CLASSES,
    REDDIT_EDGES,
    REDDIT_FEATURES,
    REDDIT_NODES,
    REDDIT_TRAIN,
)
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import read_counts, sync, zero_counts

BASELINE_SECONDS = 2.7  # the SGC paper's README (GTX 1080 Ti)

# the reference's kernel name -> the port's formulation
FORMULATION_ALIASES = {"blockdense_pallas": "blockdense_kernel"}

# the committed-admission forms reported beside the headline
FORMS = ("blockdense_kernel", "onehot")

# each kernel's launch counter in utils/profiling.py's registry, by its
# row name in chip_smoke.py's kernels line
LAUNCH_COUNTERS = {
    "blockdense_cells": "launch.blockdense_cells",           # kernel A
    "csr_spmm": "launch.csr_spmm",                           # kernel B
    "tiled_spmm": "launch.tiled_spmm",                       # kernel C
    "sddmm": "launch.sddmm",                                 # kernel D
    # GAT's attention entries (csrc/edge_softmax.cu)
    "edge_scores": "launch.edge_scores",
    "edge_softmax": "launch.edge_softmax",
    "edge_softmax_grad": "launch.edge_softmax_grad",
    "edge_scores_grad_dst": "launch.edge_scores_grad_dst",
    "edge_scores_grad_src": "launch.edge_scores_grad_src",
    # of csr_spmm's: those over a transpose (a backward)
    "csr_spmm_transposed": "within.csr_spmm_transposed",
}

REPO_ROOT = Path(__file__).resolve().parents[1]
DETAILS_PATH = REPO_ROOT / "build" / "bench_details_torch.json"

FABRIC_NOTE = ("projected_scaling's fabric figures (ici 180 GB/s, dcn 25 "
               "GB/s) are the reference's TPU v5e model constants, kept "
               "for parity; they are not figures of the H100 or NVLink")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def counted_leg(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` (a leg's result dict, ``device=`` among
    the keywords) with the launches of every kernel during the call under
    ``"launches"``."""
    zero_counts()
    out = fn(*args, **kwargs)
    sync(kwargs["device"])
    out["launches"] = read_counts(LAUNCH_COUNTERS)
    return out


def synthetic_reddit(scale: float):
    from sgc_tpu_torch.data.synthetic import synthetic_reddit as gen

    n = max(int(REDDIT_NODES * scale), 1024)
    e = max(int(REDDIT_EDGES * scale), 4096)
    log(f"building synthetic reddit (uniform): {n} nodes, ~{e} edges")
    return gen(scale)


def synthetic_reddit_clustered(scale: float):
    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered as gen

    n = max(int(REDDIT_NODES * scale), 1024)
    log(f"building synthetic reddit (clustered, shuffled ids): {n} nodes")
    return gen(scale, shuffle=True)


def real_reddit():
    from sgc_tpu_torch.data.reddit import load_reddit

    d = load_reddit("AugNormAdj", device="cpu")
    return (d.graph, np.asarray(d.features), np.asarray(d.labels),
            np.asarray(d.idx_train))


def reddit_available() -> bool:
    env = os.environ.get("SGC_TPU_DATA")
    root = Path(env) if env else Path.cwd() / "data"
    return (root / "reddit_adj.npz").exists() and (root / "reddit.npz").exists()


def resolve_formulation(name: str | None) -> str:
    """``SGC_BENCH_FORMULATION`` (default ``auto``) when ``name`` is None;
    the reference's ``blockdense_pallas`` becomes ``blockdense_kernel``,
    every other value goes to ``LocalityPlan.build`` as given."""
    if name is None:
        name = os.environ.get("SGC_BENCH_FORMULATION", "auto")
    return FORMULATION_ALIASES.get(name, name)


def _train_setup(features, labels, idx_train, device, params0=None):
    """``(params0, wd, cw, labels_train)`` on ``device``: the head from
    ``torch.Generator().manual_seed(42)`` unless ``params0`` (an SGC) is
    given, weight decay 0, unit class weights."""
    from sgc_tpu_torch.models.sgc import SGC, init_sgc

    n_classes = int(np.asarray(labels).max()) + 1
    if params0 is None:
        params0 = init_sgc(torch.Generator().manual_seed(42),
                           int(features.shape[1]), n_classes, bias=True,
                           device=device)
    else:
        params0 = SGC(params0.w.detach().to(device),
                      None if params0.b is None
                      else params0.b.detach().to(device))
    cw = torch.ones(n_classes, device=device)
    labels_train = torch.as_tensor(
        np.asarray(labels)[np.asarray(idx_train)], device=device).long()
    return params0, 0.0, cw, labels_train


def time_hops_and_head(khop, dev_args, x, params0, y, wd, cw, device,
                       trainer: str = "newton") -> dict:
    """The two timed regions of a leg: ``khop(x, dev_args)`` with the head
    fit (8 Newton steps, or 2 LBFGS epochs for ``trainer="lbfgs"``), then
    the hops alone; one warm run of the first before both, each closed by
    a synchronize. Returns the seconds and the hops' rows (``tr``)."""
    from sgc_tpu_torch.train.loops import _lbfgs_linear_fit, _newton_linear_fit

    def step():
        tr = khop(x, dev_args)
        if trainer == "newton":
            fit, _ = _newton_linear_fit(params0, tr, y, wd, cw, 8, False,
                                        False)
        else:
            fit, _ = _lbfgs_linear_fit(params0, tr, y, wd, cw, 2, False,
                                       False, 1.0)
        return fit

    t0 = time.perf_counter()
    step()      # warms the hops too: eager, they are the same calls
    sync(device)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step()
    sync(device)
    total_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = khop(x, dev_args)
    sync(device)
    hops_s = time.perf_counter() - t0
    return {"warm_s": warm_s, "total_s": total_s, "hops_s": hops_s,
            "tr": tr}


def train_parity(tr, labels_train, params0, wd, cw,
                 trainer: str = "newton") -> dict:
    """Newton vs the LBFGS oracle on the same propagated rows, the
    reference's gate: both at least 5x chance, Newton's accuracy no more
    than 2 points below LBFGS's, its loss at most 1.05x; weight decay at
    least 1e-5; if the headline budgets (8 steps / 2 epochs) disagree, a
    converged retry (32 / 16) decides. Values unrounded."""
    from sgc_tpu_torch.models.sgc import sgc_apply
    from sgc_tpu_torch.train.loops import _lbfgs_linear_fit, _newton_linear_fit

    def acc_of(p):
        pred = sgc_apply(p, tr).argmax(dim=1)
        return float((pred == labels_train).float().mean())

    wd_p = max(float(wd), 1e-5)
    chance = 1.0 / float(int(labels_train.max()) + 1)
    converged_retry = False
    for steps_n, ep_l in ((8, 2), (32, 16)):
        p_n, loss_n = _newton_linear_fit(params0, tr, labels_train, wd_p, cw,
                                         steps_n, False, False)
        p_l, loss_l = _lbfgs_linear_fit(params0, tr, labels_train, wd_p, cw,
                                        ep_l, False, False, 1.0)
        acc_n, acc_l = acc_of(p_n), acc_of(p_l)
        parity_ok = bool(
            acc_n >= 5 * chance and acc_l >= 5 * chance
            and acc_n >= acc_l - 0.02
            and float(loss_n) <= 1.05 * float(loss_l) + 1e-6)
        if parity_ok:
            break
        converged_retry = True
    return {"trainer": trainer, "newton_loss": float(loss_n),
            "lbfgs_loss": float(loss_l), "newton_train_acc": acc_n,
            "lbfgs_train_acc": acc_l, "chance_acc": chance,
            "parity_ok": parity_ok, "converged_retry": converged_retry}


def rounded_parity(tp: dict) -> dict:
    """The gate's record as the reference writes it."""
    digits = {"newton_loss": 5, "lbfgs_loss": 5, "newton_train_acc": 4,
              "lbfgs_train_acc": 4, "chance_acc": 4}
    return {k: round(v, digits[k]) if k in digits else v
            for k, v in tp.items()}


def run_uniform_segment(scale: float, data=None, device=None,
                        params0=None) -> dict:
    """The uniform synthetic through kernel B: a hop over the whole graph,
    then one over the train rows (``SparseGraph.row_subgraph``), and 2
    LBFGS epochs; ``params0`` (an SGC) replaces the seeded head."""
    from sgc_tpu_torch.ops.spmm import spmm
    from sgc_tpu_torch.train.loops import _lbfgs_linear_fit

    dev = resolve_device(device)
    graph, features, labels, idx_train = data or synthetic_reddit(scale)
    x = torch.as_tensor(features, device=dev)
    params0, wd, cw, labels_train = _train_setup(features, labels, idx_train,
                                                 dev, params0)

    graph_hop2 = graph.row_subgraph(idx_train)
    log(f"uniform hop2 row-subset: {graph_hop2.nnz / graph.nnz:.2%} of edges")
    g1, g2 = graph.to(dev), graph_hop2.to(dev)

    def precompute_and_slice():
        return spmm(g2, spmm(g1, x, impl="segment"), impl="segment")

    def fit(tr):
        return _lbfgs_linear_fit(params0, tr, labels_train, wd, cw, 2, False,
                                 False, 1.0)

    # warm both (kernel builds fall here, as CUDA kernel compilation
    # falls outside the reference's 2.7 s)
    fit(precompute_and_slice())
    sync(dev)

    t0 = time.perf_counter()
    fit(precompute_and_slice())
    sync(dev)
    total = time.perf_counter() - t0

    t0 = time.perf_counter()
    precompute_and_slice()
    sync(dev)
    t_pre = time.perf_counter() - t0
    edges = graph.nnz + graph_hop2.nnz
    log(f"uniform: precompute+slice {t_pre:.3f}s "
        f"({edges / t_pre / 1e6:.0f} M edges/s)  total {total:.3f}s")
    return {
        "total_s": total,
        "precompute_s": t_pre,
        "edges": edges,
        "edges_per_s": edges / t_pre,
        "graph": graph,
        "n_features": int(features.shape[1]),
    }


def measure_roofline(plan, x, dispatch_s: float) -> dict:
    """Per-term times of the main split's hop, the dense cells (kernel A)
    and the remainder (kernel B adding the dense term), beside their
    byte and operation counts (``ops/roofline.py::roofline_report``). A
    onehot plan has no cell term here and reports nothing, as in the
    reference."""
    from sgc_tpu_torch.ops import roofline as rf
    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain

    split = plan.split_main
    if not hasattr(split, "cells"):
        return {}
    args_main, _ = plan._device_args()
    plain = plan.formulation == "blockdense"
    cells = bd.apply_cells_plain if plain else bd.apply_cells
    segment = spmm_segment_plain if plain else spmm_segment
    dev = x.device

    def timed(fn, reps=2):
        fn()
        sync(dev)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    dense = cells(split, args_main, x, "f32") if split.n_cells else None
    dense_s = (timed(lambda: cells(split, args_main, x, "f32"))
               if split.n_cells else 0.0)
    rest_s = (timed(lambda: segment(args_main.rest, x, dense))
              if split.rest is not None else 0.0)
    rep = rf.roofline_report(split, int(x.shape[1]), dense_s, rest_s,
                             dispatch_s=dispatch_s)
    log(f"roofline: dense {dense_s*1e3:.2f}ms "
        f"({rep['dense']['achieved_gbps']} GB/s, "
        f"{rep['dense']['hbm_frac']:.0%} HBM, "
        f"{rep['dense']['mxu_frac_padded']:.0%} tensor cores padded)  "
        f"remainder {rest_s*1e3:.2f}ms ({rep['remainder']['edges']} edges, "
        f"{rep['remainder']['edges_per_s']/1e6:.0f}M edges/s)  "
        f"dispatch {dispatch_s*1e3:.3f}ms")
    return rep


def measure_dispatch_floor(device) -> float:
    """Round trip of a trivial device op closed by a synchronize, best of
    3: the per-region latency floor every timed region pays."""
    v = torch.ones((8, 128), dtype=torch.float32, device=device)
    v * 2.0 + 1.0
    sync(device)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        v * 2.0 + 1.0
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def run_clustered_hybrid(scale: float, data=None, name: str = "clustered",
                         device=None, params0=None,
                         formulation: str | None = None,
                         calibrate: bool = True,
                         audit: bool | None = None) -> dict:
    """The locality pipeline: ``LocalityPlan.build`` (LPA order, then the
    split of ``formulation``, cells admitted by the device's measured
    rates under ``calibrate``), 2 hops and the head, timed.

    ``formulation`` None reads ``SGC_BENCH_FORMULATION``. ``audit`` (the
    per-term roofline and the parity gate) defaults to the headline leg
    only, as in the reference. ``params0`` (an SGC) replaces the seeded
    head, so two packages can start from the same numbers."""
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops.calibrate import measured_rates
    from sgc_tpu_torch.utils.profiling import stack_sampler

    dev = resolve_device(device)
    if data is None:
        data = synthetic_reddit_clustered(scale)
    graph, features, labels, idx_train = data
    formulation = resolve_formulation(formulation)
    if audit is None:
        audit = name == "clustered"

    rates = measured_rates(dev)
    log(f"admission rates: {rates}")
    sampler = (stack_sampler()
               if os.environ.get("SGC_BENCH_PROFILE_PLAN")
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with sampler:
        plan = LocalityPlan.build(graph, features, labels, idx_train,
                                  formulation=formulation,
                                  calibrate=calibrate, device=dev)
    prep_s = time.perf_counter() - t0
    if hasattr(sampler, "report"):
        log(f"prep profile ({name}): {sampler.report()}")
    s = plan.split_main
    extra = (f"cells {s.n_cells} ({s.cell_bytes / 1e9:.2f} GB bf16)"
             if hasattr(s, "cells") else f"pad {s.pad:.3f}")
    log(f"{name} prep {prep_s:.1f}s ({plan.prep_seconds}); "
        f"dense_frac {plan.dense_fraction:.3f} {extra}")

    x = torch.as_tensor(plan.features, device=dev)
    params0, wd, cw, labels_train = _train_setup(
        plan.features, plan.labels, plan.idx_train, dev, params0)
    # the plan's arrays are placed on the device here, before any timer
    khop, dev_args = plan.khop_traceable(degree=2)
    trainer = os.environ.get("SGC_BENCH_TRAINER", "newton")

    t = time_hops_and_head(khop, dev_args, x, params0, labels_train, wd, cw,
                           dev, trainer)
    log(f"{name} warm: {t['warm_s']:.1f}s")
    total, t_pre, tr = t["total_s"], t["hops_s"], t["tr"]
    edges = plan.graph.nnz + plan.graph_final.nnz
    log(f"{name}: hops {t_pre:.4f}s ({edges / t_pre / 1e6:.0f} M edges/s)"
        f"  total {total:.4f}s")

    roofline, tp = {}, {}
    if audit:
        roofline = measure_roofline(plan, x, measure_dispatch_floor(dev))
        tp = rounded_parity(train_parity(tr, labels_train, params0, wd, cw,
                                         trainer))
        log(f"train parity ({name}): {tp}")

    return {
        "total_s": total,
        "precompute_s": t_pre,
        "edges": edges,
        "edges_per_s": edges / t_pre,
        "dense_frac": plan.dense_fraction,
        "prep_s": round(prep_s, 1),
        "prep_stages": {k: round(v, 2) for k, v in plan.prep_seconds.items()},
        "admission_rates": rates,
        "roofline": roofline,
        "train_parity": tp,
        "trainer": trainer,
        "graph": plan.graph,
        "n_features": int(plan.features.shape[1]),
        # the RESOLVED form (auto -> blockdense_kernel on the card)
        "formulation": plan.formulation,
    }


COMPACT_MAX_CHARS = 1200  # the driver's tail-capture budget


def compact_summary(out: dict, details_path: str) -> dict:
    """The machine-read stdout line: every tracked field, none of the
    audit bulk (``projected_scaling``, ``roofline``, the comm sweep),
    which stays in the sidecar at ``details_path``; at most
    :data:`COMPACT_MAX_CHARS` serialized. The reference's keys, less
    ``hugealloc_installed``; ``forms`` maps each form to its ``hops_s``."""
    keep = (
        "metric", "value", "unit", "vs_baseline", "edges_per_s",
        "trainer", "formulation", "dense_frac", "host_prep_s",
        "uniform_segment_s", "vs_baseline_uniform_segment",
        "uniform_edges_per_s", "vs_baseline_uniform", "uniform_auto_s",
        "native_available", "nproc",
    )
    c = {k: out[k] for k in keep if k in out}
    prep = out.get("prep_seconds")
    if prep:
        c["prep_seconds"] = {
            k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in prep.items()
        }
    tp = out.get("train_parity")
    if tp:
        c["train_parity"] = {
            k: tp[k]
            for k in ("trainer", "newton_loss", "lbfgs_loss",
                      "newton_train_acc", "lbfgs_train_acc", "chance_acc",
                      "parity_ok", "converged_retry")
            if k in tp
        }
    forms = out.get("forms")
    if forms:
        c["forms"] = {k: round(v["hops_s"], 5) for k, v in forms.items()}
    if isinstance(out.get("data"), str):
        c["data"] = out["data"].split(" (")[0]
    c["details"] = details_path
    return c


def card_line(device) -> str | None:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
    None on the CPU."""
    if device.type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def run_forms(scale: float, data, device, params0=None) -> dict:
    """The clustered data under each of :data:`FORMS` at the committed
    admission, each timed, with its roofline and its parity gate."""
    forms = {}
    for form in FORMS:
        r = counted_leg(run_clustered_hybrid, scale, data=data,
                        name=f"forms.{form}", device=device, params0=params0,
                        formulation=form, calibrate=False, audit=True)
        forms[form] = {"hops_s": r["precompute_s"], "total_s": r["total_s"],
                       "edges_per_s": r["edges_per_s"],
                       "dense_frac": r["dense_frac"], "prep_s": r["prep_s"],
                       "prep_stages": r["prep_stages"],
                       "formulation": r["formulation"],
                       "train_parity": r["train_parity"],
                       "parity_ok": r["train_parity"]["parity_ok"],
                       "roofline": r["roofline"], "launches": r["launches"]}
    return forms


def sharded_plan_stats(head: dict) -> dict:
    """The 8-part sharded block-dense plan, built on the host
    (``device=False``): how much of the graph the sharded path would run
    as cells, and the build's stages."""
    from sgc_tpu_torch.parallel.blockdense import build_sharded_blockdense
    from sgc_tpu_torch.parallel.halo import build_halo
    from sgc_tpu_torch.parallel.partition import partition_graph
    from sgc_tpu_torch.utils.profiling import stack_sampler

    sampler = (stack_sampler()
               if os.environ.get("SGC_BENCH_PROFILE_PLAN")
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with sampler:
        pg = partition_graph(head["graph"], 8, device=False)
        t1 = time.perf_counter()
        halo = build_halo(pg, device=False)
        t2 = time.perf_counter()
        bd = build_sharded_blockdense(pg, halo, head["n_features"],
                                      device=False)
        t3 = time.perf_counter()
    if hasattr(sampler, "report"):
        log(f"plan profile: {sampler.report()}")
    return {
        "n_parts": pg.n_parts,
        "dense_fraction": round(bd.dense_fraction, 3),
        "n_cells": bd.n_cells,
        "cells_interior_width": int(bd.cells_int.shape[1]),
        "cells_boundary_width": int(bd.cells_bnd.shape[1]),
        "build_s": round(t3 - t0, 1),
        "partition_s": round(t1 - t0, 1),
        "halo_s": round(t2 - t1, 1),
        "cells_s": round(t3 - t2, 1),
    }


def projected_scaling(head: dict) -> dict:
    """The communication model at 8 devices from the headline's edge
    rate, the 8-part sharded plan and the device-count x fabric sweep
    (host arithmetic, untimed)."""
    from sgc_tpu_torch.parallel.scaling import comm_model, comm_sweep

    model = comm_model(head["graph"], head["n_features"], 8,
                       head["edges_per_s"], build_plan=False)
    model["rate_formulation"] = head.get("formulation", "segment")
    model["sharded_blockdense_plan"] = sharded_plan_stats(head)
    t0 = time.perf_counter()
    sweep = comm_sweep(head["graph"], head["n_features"],
                       head["edges_per_s"])
    sweep["sweep_build_s"] = round(time.perf_counter() - t0, 1)
    model["comm_sweep"] = sweep
    log(f"comm sweep: first below 0.8 = {sweep['first_below_target']}")
    model["fabric_note"] = FABRIC_NOTE
    return model


def leg_summary(leg: dict) -> dict:
    """A leg's spans, split and launches for the sidecar, unrounded."""
    return {k: leg[k] for k in ("total_s", "precompute_s", "edges",
                                "edges_per_s", "dense_frac", "formulation",
                                "launches") if k in leg}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    scale = float(os.environ.get("SGC_BENCH_SCALE", "1.0"))
    topology = os.environ.get("SGC_BENCH_TOPOLOGY", "both")
    if topology not in ("both", "clustered", "uniform"):
        raise SystemExit(
            f"SGC_BENCH_TOPOLOGY={topology!r}: expected both|clustered|uniform"
        )
    dev = resolve_device(args.device)
    card = card_line(dev)
    log(f"torch {torch.__version__}, device {dev}"
        + (f": {card}" if card else ""))
    if dev.type == "cuda":
        from sgc_tpu_torch.ops.capability import require_cuda_kernels

        # set-up: the kernels' build and capability check, never inside
        # a leg's prep or timed span
        require_cuda_kernels(dev)

    real = None
    if reddit_available() and scale >= 1.0:
        log("using real Reddit data (adaptive pipeline)")
        real = real_reddit()

    clustered = uniform = uniform_auto = forms = None
    if real is not None:
        clustered = counted_leg(run_clustered_hybrid, scale, data=real,
                                device=dev)
        forms = run_forms(scale, real, dev)
    else:
        if topology in ("both", "clustered"):
            cdata = synthetic_reddit_clustered(scale)
            clustered = counted_leg(run_clustered_hybrid, scale,
                                    data=cdata, device=dev)
            forms = run_forms(scale, cdata, dev)
            del cdata
        if topology in ("both", "uniform"):
            udata = synthetic_reddit(scale)
            uniform = counted_leg(run_uniform_segment, scale, data=udata,
                                  device=dev)
            uniform_auto = counted_leg(run_clustered_hybrid, scale,
                                       data=udata, name="uniform-auto",
                                       device=dev)
            del udata

    head = clustered or uniform
    model = projected_scaling(head)

    out = {
        "metric": "reddit_sgc_precompute_train_s",
        "value": round(head["total_s"], 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / head["total_s"], 3),
        "edges_per_s": int(head["edges_per_s"]),
        "ici_bytes_per_hop": model.get("ici_bytes_per_hop_halo"),
        "projected_scaling": model,
        "device": str(dev),
        "card": card,
        "scale": scale,
    }
    if real is not None:
        out["data"] = "real_reddit"
    elif clustered is not None:
        out["data"] = (
            "synthetic clustered (85% intra, 50 communities, shuffled "
            f"ids; lpa reorder + {clustered['formulation']} split)")
    if clustered is not None:
        from sgc_tpu_torch import native

        out["formulation"] = clustered["formulation"]
        out["dense_frac"] = round(clustered["dense_frac"], 3)
        out["host_prep_s"] = clustered["prep_s"]
        out["prep_seconds"] = clustered["prep_stages"]
        out["native_available"] = native.available()
        out["trainer"] = clustered["trainer"]
        out["train_parity"] = clustered["train_parity"]
        out["nproc"] = os.cpu_count()
        out["admission_rates"] = clustered["admission_rates"]
        out["roofline"] = clustered["roofline"]
        out["forms"] = forms
    if uniform is not None:
        out["uniform_segment_s"] = round(uniform["total_s"], 4)
        out["vs_baseline_uniform_segment"] = round(
            BASELINE_SECONDS / uniform["total_s"], 3)
        out["uniform_edges_per_s"] = int(uniform["edges_per_s"])
        out["vs_baseline_uniform"] = round(
            BASELINE_SECONDS / uniform_auto["total_s"], 3)
        out["uniform_auto_s"] = round(uniform_auto["total_s"], 4)
        out["uniform_auto_formulation"] = uniform_auto["formulation"]
        out["uniform_auto_dense_frac"] = round(uniform_auto["dense_frac"], 3)
    out["legs"] = {name: leg_summary(leg) for name, leg in (
        ("clustered", clustered), ("uniform_segment", uniform),
        ("uniform_auto", uniform_auto)) if leg is not None}

    # the full audit blob to the sidecar; stdout carries only the compact
    # line, so a bounded tail capture always parses it
    DETAILS_PATH.parent.mkdir(parents=True, exist_ok=True)
    DETAILS_PATH.write_text(json.dumps(out, indent=1))
    log(f"full detail blob -> {DETAILS_PATH}")
    rel = str(DETAILS_PATH.relative_to(REPO_ROOT))
    line = json.dumps(compact_summary(out, rel))
    print(line, flush=True)
    if len(line) > COMPACT_MAX_CHARS:
        raise SystemExit(f"compact line {len(line)} chars > "
                         f"{COMPACT_MAX_CHARS}")
    gates = {"clustered": out.get("train_parity", {}).get("parity_ok"),
             **{f"forms.{k}": v["parity_ok"] for k, v in (forms or {}).items()}}
    failed = [k for k, ok in gates.items() if ok is False]
    if failed:
        raise SystemExit(f"train parity failed: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
