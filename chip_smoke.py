#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``sgc_tpu_torch``) on one card.

    python3 chip_smoke.py [--scale 1.0] [--seed 42] [--reps 5]

Drives the port's main path once at full model width (F = 602, 41
classes, 512 x 512 cells, K = 2 hops, 8 Newton steps), the clustered
Reddit-shaped SGC pipeline:

    synthetic_reddit_clustered(scale, shuffle=True)
    -> LocalityPlan.build(formulation="auto")      (LPA order + splits)
    -> khop_traceable(degree=2, precision="f32")   (kernel A + kernel B)
    -> _newton_linear_fit(steps=8), gated against the LBFGS oracle

then runs the same hops under the admission rates measured on the card
(``calibrate=True``), and the reference's other formulation on the same
data, counters zeroed just before it and read just after:

    -> LocalityPlan.build(formulation="onehot")    (hybrid splits)
    -> khop_traceable(degree=2)                    (kernel C + kernel B)
    -> _newton_linear_fit(steps=8), gated against the LBFGS oracle

It then holds each CUDA kernel against its plain PyTorch version on the
paths' own inputs (kernel A at both precisions in both cell orders and
in the grouped layout, kernel B, kernel C through both entries (kernel
B's CUDA kernel on the tiled layout's edges re-sorted by row; "f32" and
"bf16"), kernel D through ``sddmm`` with two different operands on the
main operator (both precisions) and on the same graph in its shuffled
order), checks that kernels A, C and D give identical bits across two
launches, and drives ``spmm(impl=...)`` for every impl.

Then it drives the user-facing entry points, counters zeroed just before
each run and read just after:

    reddit_cli:   a Reddit-format pair at Reddit's published shape
                  (232,965 nodes, the directed half of 11,606,919 edges,
                  602 features, 41 classes, GraphSAGE's 152,410 / 23,699
                  / 55,334 split; clustered recipe from --seed, written
                  under build/) -> cli.reddit.run(inductive=True,
                  test=True), plain (kernel B) and locality=True
                  (calibrated LocalityPlan), eval features of both held
                  together, micro-F1 above 5x chance on each
    citation_cli: a Planetoid-format set at Pubmed's shape (19,717
                  nodes, 44,338 edges, 500 features, 3 classes; 60 / 500
                  / 1,000) -> cli.citation.run for sgc, appnp and ssgc,
                  cli.sweep.sweep(K = 1, 2, 3), sgc_precompute(degree=2)
                  under every impl against segment with each impl's
                  kernels counted, and out_rows=idx_test bit-equal to the
                  full result's rows

Phases print one JSON line each on stdout; the line before the last is
``{"kernels": [...]}`` (each row also carries its launches on the new
paths, ``launches_by_path``) and the last is ``{"ok": true, "device":
{...}}``. Any failed phase raises, so the script exits non-zero and
prints no result; so does a run without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

# device peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, dense bf16 on the tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# relative to max|plain|: kernel and plain differ only in f32 sum order
TOLERANCE = 1e-5
# relative to max|main path|: bf16 cells vs f32 edges (2^-8 per value)
BF16_TOLERANCE = 1e-2
# edges per warp of kernel D (csrc/sddmm.cu's SEG), to count its row runs
SDDMM_SEG = 64


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``reps`` calls after one warm call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output has non-finite values")
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def bound_ms(ops: float, nbytes: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops = ops / peak_flops
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # FP32 matmuls in the plain versions stay full FP32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return card


def phase_build() -> None:
    from sgc_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    seconds = kernels.build_all()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_library_s": seconds})


def phase_calibrate(device) -> dict:
    from sgc_tpu_torch.ops.calibrate import measured_rates
    from sgc_tpu_torch.ops.capability import require_cuda_kernels
    from sgc_tpu_torch.ops.spmm_blockdense import min_edges_for

    t0 = time.perf_counter()
    require_cuda_kernels(device)
    t1 = time.perf_counter()
    rates = measured_rates(device)
    t2 = time.perf_counter()
    min_edges = min_edges_for(512, 512, 602,
                              eff_flops=rates["blockdense_eff_flops"],
                              xla_edges_per_s=rates["xla_edges_per_s"])
    emit({"phase": "calibrate", "capability_s": t1 - t0,
          "calibrate_s": t2 - t1, "rates": rates,
          "min_edges_per_cell": min_edges})
    return rates


def drive_plan(plan, device, counters) -> dict:
    """One user-level run of a plan: ``khop_traceable(degree=2)`` and the
    8-step Newton head, warm, then timed; the launch counters in
    ``counters`` ({name: module}) are zeroed just before and read just
    after the timed run and the timed hops."""
    import torch

    from sgc_tpu_torch.models.sgc import init_sgc
    from sgc_tpu_torch.train.loops import _newton_linear_fit
    from sgc_tpu_torch.utils.profiling import sync

    x = torch.as_tensor(plan.features, device=device)
    n_classes = int(plan.labels.max()) + 1
    params0 = init_sgc(torch.Generator().manual_seed(42), x.shape[1],
                       n_classes, device=device)
    y = torch.as_tensor(plan.labels[plan.idx_train], device=device).long()
    cw = torch.ones(n_classes, device=device)
    khop, dev_args = plan.khop_traceable(degree=2, precision="f32")

    def step():
        tr = khop(x, dev_args)
        fit, _ = _newton_linear_fit(params0, tr, y, 0.0, cw, 8, False, False)
        return fit

    t0 = time.perf_counter()
    step()
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
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}
    if tuple(tr.shape) != (len(plan.idx_train), x.shape[1]):
        raise AssertionError(f"propagated shape {tuple(tr.shape)}")
    edges = plan.graph.nnz + plan.graph_final.nnz
    return {"x": x, "y": y, "cw": cw, "params0": params0, "tr": tr,
            "dev_args": dev_args, "launches": launches,
            "timings": {"warm_s": warm_s, "total_s": total_s,
                        "hops_s": hops_s, "edges": edges,
                        "edges_per_s": edges / hops_s}}


def phase_main_path(args, device) -> dict:
    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import spmm, spmm_blockdense
    from sgc_tpu_torch.train.loops import (
        _lbfgs_linear_fit,
        _newton_linear_fit,
    )

    counters = {"blockdense_cells": spmm_blockdense, "csr_spmm": spmm}
    for mod in counters.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    graph, features, labels, idx_train = synthetic_reddit_clustered(
        args.scale, seed=args.seed, shuffle=True)
    emit({"phase": "data", "data_s": time.perf_counter() - t0,
          "nodes": graph.n_rows, "nnz": graph.nnz,
          "features": int(features.shape[1]),
          "classes": int(labels.max()) + 1, "train": len(idx_train)})

    t0 = time.perf_counter()
    plan = LocalityPlan.build(graph, features, labels, idx_train,
                              formulation="auto", device=device)
    prep_s = time.perf_counter() - t0
    s = plan.split_main
    log(f"plan: {plan.formulation}, dense_frac {plan.dense_fraction:.4f}, "
        f"cells {s.n_cells}, prep {prep_s:.1f}s {plan.prep_seconds}")
    run = drive_plan(plan, device, counters)
    x, tr, launches = run["x"], run["tr"], run["launches"]

    # the propagated rows against the plain formulation on the card
    (a_main, a_final) = run["dev_args"]
    plain_tr = spmm_blockdense.spmm_block_dense(
        plan.split_final,
        spmm_blockdense.spmm_block_dense(plan.split_main, x, a_main,
                                         precision="f32"),
        a_final, precision="f32")
    abs_err, err = rel_err(tr, plain_tr)
    if not err <= TOLERANCE:
        raise AssertionError(f"propagation vs plain: rel err {err:.3e}")
    del plain_tr

    parity = train_parity(tr, run["y"], run["params0"], run["cw"],
                          _newton_linear_fit, _lbfgs_linear_fit)
    emit({"phase": "main_path", "formulation": plan.formulation,
          "precision": "f32",
          "calibrate": False, "min_edges": s.min_edges,
          "dense_frac": plan.dense_fraction,
          "cells_main": s.n_cells, "cells_final": plan.split_final.n_cells,
          "sparse_edges_main": s.sparse_edges,
          "cell_gb": (s.cell_bytes + plan.split_final.cell_bytes) / 1e9,
          "prep_s": prep_s, "prep_stages": plan.prep_seconds,
          **run["timings"], "launches": launches,
          "propagation_max_abs_err": abs_err,
          "propagation_rel_err": err, "train_parity": parity})
    if not parity["parity_ok"]:
        raise AssertionError(f"train parity failed: {parity}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"plan": plan, "x": x, "launches": launches,
            "data": (graph, features, labels, idx_train), "tr": tr}


def phase_onehot_path(data, device) -> dict:
    """The reference's other formulation on the same data:
    ``LocalityPlan.build(formulation="onehot")`` (hybrid splits), two
    hops through kernel C (dense cells) and kernel B (remainder), the
    Newton head; rows held against kernel B alone over the whole
    operators, and the head against the LBFGS oracle."""
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.ops import spmm, spmm_tiled
    from sgc_tpu_torch.train.loops import (
        _lbfgs_linear_fit,
        _newton_linear_fit,
    )

    counters = {"tiled_spmm": spmm_tiled, "csr_spmm": spmm}
    for mod in counters.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    plan = LocalityPlan.build(*data, formulation="onehot", device=device)
    prep_s = time.perf_counter() - t0
    run = drive_plan(plan, device, counters)
    x, tr, launches = run["x"], run["tr"], run["launches"]

    # all-segment oracle: kernel B alone over the whole operators
    g_main = plan.graph.to(device)
    g_final = plan.graph_final.to(device)
    oracle = spmm.spmm_segment(g_final, spmm.spmm_segment(g_main, x))
    abs_err, err = rel_err(tr, oracle)
    del oracle
    if not err <= TOLERANCE:
        raise AssertionError(f"onehot rows vs all-segment: {err:.3e}")
    parity = train_parity(tr, run["y"], run["params0"], run["cw"],
                          _newton_linear_fit, _lbfgs_linear_fit)
    s, sf = plan.split_main, plan.split_final
    emit({"phase": "onehot_path", "formulation": plan.formulation,
          "min_fill": s.min_fill, "dense_frac": plan.dense_fraction,
          "dense_edges_main": s.dense_edges,
          "sparse_edges_main": s.sparse_edges,
          "slots_main": int(s.tiled.rows.shape[0]), "pad_main": s.pad,
          "slots_final": int(sf.tiled.rows.shape[0]), "pad_final": sf.pad,
          "prep_s": prep_s, "prep_stages": plan.prep_seconds,
          **run["timings"], "launches": launches,
          "rows_vs_all_segment_max_abs_err": abs_err,
          "rows_vs_all_segment_rel_err": err, "train_parity": parity})
    if not parity["parity_ok"]:
        raise AssertionError(f"onehot train parity failed: {parity}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"plan": plan, "x": x, "launches": launches, "graph": g_main}


def phase_calibrated_path(data, tr_main, device) -> None:
    """The same hops under admission by the rates measured on this card
    (``calibrate=True``): the split the card's own cost model picks, its
    dense fraction and hop time, and its rows against the main path's."""
    import torch

    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.utils.profiling import sync

    t0 = time.perf_counter()
    plan = LocalityPlan.build(*data, formulation="auto", calibrate=True,
                              device=device)
    prep_s = time.perf_counter() - t0
    khop, dev_args = plan.khop_traceable(degree=2, precision="f32")
    x = torch.as_tensor(plan.features, device=device)
    khop(x, dev_args)
    sync(device)
    t0 = time.perf_counter()
    tr = khop(x, dev_args)
    sync(device)
    hops_s = time.perf_counter() - t0
    # the main path stores its cells' values in bf16, this split keeps
    # (almost) every edge in f32: they agree to bf16 rounding of the
    # operator, not to f32
    _, err = rel_err(tr, tr_main)
    if not err <= BF16_TOLERANCE:
        raise AssertionError(f"calibrated vs main path rows: {err:.3e}")
    edges = plan.graph.nnz + plan.graph_final.nnz
    emit({"phase": "calibrated_path", "precision": "f32",
          "min_edges": plan.split_main.min_edges,
          "dense_frac": plan.dense_fraction,
          "cells_main": plan.split_main.n_cells,
          "cells_final": plan.split_final.n_cells, "prep_s": prep_s,
          "hops_s": hops_s, "edges_per_s": edges / hops_s,
          "rows_vs_main_path_rel_err": err})


def train_parity(tr, y, params0, cw, newton_fit, lbfgs_fit) -> dict:
    """Newton vs the LBFGS oracle on the same propagated rows, as the
    reference bench gates it: both >= 5x chance, Newton's accuracy within
    2 points of LBFGS's or better and its loss within 5%; a converged
    retry (32 Newton steps / 16 LBFGS epochs) decides a disagreement."""
    def acc_of(model):
        return float((model(tr).argmax(dim=1) == y).float().mean())

    wd = 1e-5
    chance = 1.0 / float(int(y.max()) + 1)
    converged_retry = False
    for steps_n, ep_l in ((8, 2), (32, 16)):
        p_n, loss_n = newton_fit(params0, tr, y, wd, cw, steps_n, False,
                                 False)
        p_l, loss_l = lbfgs_fit(params0, tr, y, wd, cw, ep_l, False, False,
                                1.0)
        acc_n, acc_l = acc_of(p_n), acc_of(p_l)
        parity_ok = bool(acc_n >= 5 * chance and acc_l >= 5 * chance
                         and acc_n >= acc_l - 0.02
                         and float(loss_n) <= 1.05 * float(loss_l) + 1e-6)
        if parity_ok:
            break
        converged_retry = True
    return {"trainer": "newton", "newton_loss": float(loss_n),
            "lbfgs_loss": float(loss_l), "newton_train_acc": acc_n,
            "lbfgs_train_acc": acc_l, "chance_acc": chance,
            "parity_ok": parity_ok, "converged_retry": converged_retry}


def cells_csr(split, dargs, n_slots):
    """The nonzero entries of the first ``n_slots`` cell slots (their bf16
    values, widened) as one CSR matrix on the card: kernel A's function at
    precision "f32" as a sparse matrix (yardstick only). Zero slots (the
    grouped layout's holes) add no entry."""
    import torch

    R, W = split.row_block, split.stripe
    cells = dargs.cells[:n_slots]
    k, r, w = cells.nonzero(as_tuple=True)
    rb = torch.as_tensor(split.rb_ids[:n_slots], device=cells.device)
    st = torch.as_tensor(split.st_ids[:n_slots], device=cells.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        return torch.sparse_coo_tensor(
            torch.stack([rb[k].long() * R + r, st[k].long() * W + w]),
            cells[k, r, w].float(),
            (split.n_rows, split.n_cols)).coalesce().to_sparse_csr()


def kernel_a_bound(split, dargs, n_cells, F, passes) -> dict:
    """Kernel A's bound on this run's cells: 2 F flops per nonzero cell
    entry and pass at the bf16 tensor-core peak (the work the function
    needs), against the cells, x, out and the index read or written once.
    Beside it, the one-pass bound and the dense form's bound (2 R W F
    flops per real cell and pass, what the kernel does)."""
    R, W = split.row_block, split.stripe
    nnz = int(dargs.cells[: split.n_slots].count_nonzero())
    ops = 2.0 * nnz * F
    dense_ops = 2.0 * R * W * F * n_cells
    nbytes = (split.n_slots * R * W * 2 + split.n_cols * F * 4
              + split.n_rows * F * 4
              + (split.n_row_blocks + 1 + 2 * split.n_slots) * 4)
    b_ms, b_by = bound_ms(ops * passes, nbytes, PEAK_BF16_TC_FLOPS)
    one_ms, _ = bound_ms(ops, nbytes, PEAK_BF16_TC_FLOPS)
    dense_ms, dense_by = bound_ms(dense_ops * passes, nbytes,
                                  PEAK_BF16_TC_FLOPS)
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_one_pass_ms": one_ms,
            "cell_nonzeros": nnz, "ops": ops * passes, "bytes": nbytes,
            "dense_form_ops": dense_ops * passes,
            "dense_form_bound_ms": dense_ms,
            "dense_form_bound_by": dense_by}


def phase_kernel_a(plan, x, launches, reps) -> dict:
    """Kernel A in both cell orders at both precisions on the main split,
    and at both precisions on the last-hop split: two launches equal bit
    for bit, "f32" held against the plain f32 product and "bf16" against
    the plain product on bf16-rounded x, both at 1e-5."""
    import torch

    from sgc_tpu_torch.ops import spmm_blockdense as bd

    R, W = plan.split_main.row_block, plan.split_main.stripe
    F = int(x.shape[1])
    split_super = plan.split_main
    args_super = plan._device_args()[0]
    split_classic = bd.split_block_dense(
        plan.graph, F, R, W, min_edges=split_super.min_edges,
        super_rows=None)
    if split_classic.n_cells != split_super.n_cells:
        raise AssertionError("the two cell orders admitted different cells")
    args_classic = bd.blockdense_device_args(split_classic, x.device)
    orders = {}
    for name, split, dargs in (("super_rows_8", split_super, args_super),
                               ("classic", split_classic, args_classic)):
        for precision in bd.PRECISIONS:
            got = bd.apply_cells(split, dargs, x, precision)
            again = bd.apply_cells(split, dargs, x, precision)
            want = bd.apply_cells_plain(split, dargs, x, precision)
            abs_err, err = rel_err(got, want)
            if not err <= TOLERANCE:
                raise AssertionError(
                    f"kernel A ({name}, {precision}) vs plain: {err:.3e}")
            if not torch.equal(got, again):
                raise AssertionError(f"kernel A ({name}, {precision}): two "
                                     "launches differ")
            del got, again, want
            orders[f"{name}/{precision}"] = {
                "max_abs_err": abs_err, "rel_err": err,
                "ms": time_ms(
                    lambda: bd.apply_cells(split, dargs, x, precision), reps),
                "plain_ms": time_ms(
                    lambda: bd.apply_cells_plain(split, dargs, x, precision),
                    2)}
    del args_classic
    # the last hop's split (train rows only), for the hop-time breakdown
    args_final = plan._device_args()[1]
    final_ms = {p: time_ms(
        lambda: bd.apply_cells(plan.split_final, args_final, x, p), reps)
        for p in bd.PRECISIONS}

    n_real = split_super.n_cells
    # yardstick 1 (not the same function): one gathered f32 bmm of every
    # cell against its stripe, the per-cell products without the sum
    xp = x.new_zeros((split_super.n_stripes * W, F))
    xp[: x.shape[0]] = x
    st = torch.as_tensor(split_super.st_ids[:n_real], device=x.device).long()
    cells_f32 = args_super.cells[:n_real].float()
    xg = xp.view(-1, W, F)[st]
    bmm_ms = time_ms(lambda: torch.bmm(cells_f32, xg), reps)
    del cells_f32, xg, xp
    # yardstick 2 (the same function as precision "f32"): the cells'
    # nonzero entries as one CSR matrix, torch.addmm
    csr = cells_csr(split_super, args_super, n_real)
    zero = x.new_zeros((split_super.n_rows, F))
    library_ms = time_ms(lambda: torch.addmm(zero, csr, x, beta=0.0), reps)
    csr_nnz = int(csr._nnz())
    del csr, zero

    main = "super_rows_8/f32"
    passes = bd.n_passes("f32")
    bound = kernel_a_bound(split_super, args_super, n_real, F, passes)
    if bound["cell_nonzeros"] != csr_nnz:
        raise AssertionError("kernel A's bound and its CSR yardstick count "
                             "different nonzeros")
    bf16_ms = orders["super_rows_8/bf16"]["ms"]
    row = {"name": "blockdense_cells", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/blockdense.cu",
           "replaces": ("sgc_tpu/ops/spmm_blockdense.py:353, :330, :381"),
           "precision": "f32", "passes": passes,
           "launches": launches["blockdense_cells"],
           "max_abs_err": max(o["max_abs_err"] for o in orders.values()),
           "ms": orders[main]["ms"], "plain_ms": orders[main]["plain_ms"],
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "library_ms": library_ms}
    emit({"phase": "kernel_a", "cells": n_real, "F": F, "orders": orders,
          "final_split_cells": plan.split_final.n_cells,
          "final_split_ms": final_ms, "bf16_ms": bf16_ms,
          "launches_note": "calls of kernel A's entry; each is two CUDA "
                           "launches (x_terms_kernel, then the MMA kernel)",
          "library": "torch.addmm, the cells' nonzeros as one CSR matrix "
                     f"({csr_nnz} entries): the same function as 'f32'",
          "bmm_f32_yardstick_ms": bmm_ms, "tolerance_rel": TOLERANCE,
          **bound,
          "dense_form_achieved_tflops":
              bound["dense_form_ops"] / orders[main]["ms"] / 1e9,
          "bf16_dense_form_achieved_tflops":
              bound["dense_form_ops"] / passes / bf16_ms / 1e9, **row})
    return row


def phase_kernel_b(plan, x, launches, reps) -> dict:
    import numpy as np
    import torch

    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain

    split = plan.split_main
    dargs = plan._device_args()[0]
    rest = dargs.rest
    dense = bd.apply_cells(split, dargs, x, "f32")
    got = spmm_segment(rest, x, dense)
    want = spmm_segment_plain(rest, x, dense)
    abs_err, err = rel_err(got, want)
    if not err <= TOLERANCE:
        raise AssertionError(f"kernel B vs plain: {err:.3e}")
    del got, want
    ms = time_ms(lambda: spmm_segment(rest, x, dense), reps)
    plain_ms = time_ms(lambda: spmm_segment_plain(rest, x, dense), 2)
    args_final = plan._device_args()[1]
    dense_final = bd.apply_cells(plan.split_final, args_final, x, "f32")
    final_ms = time_ms(
        lambda: spmm_segment(args_final.rest, x, dense_final), reps)
    nnz = rest.nnz
    csr = csr_of(rest)
    library_ms = time_ms(lambda: torch.addmm(dense, csr, x), reps)

    F = int(x.shape[1])
    n_used_cols = int(np.unique(split.rest.cols[:nnz]).size)
    ops = 2.0 * nnz * F + rest.n_rows * F
    nbytes = (nnz * 8 + (rest.n_rows + 1) * 4 + n_used_cols * F * 4
              + 2 * rest.n_rows * F * 4)
    b_ms, b_by = bound_ms(ops, nbytes)
    row = {"name": "csr_spmm", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/spmm_csr.cu",
           "replaces": "sgc_tpu/ops/spmm.py:45",
           "launches": launches["csr_spmm"], "max_abs_err": abs_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms}
    emit({"phase": "kernel_b", "nnz": nnz, "F": F, "rel_err": err,
          "final_split_nnz": args_final.rest.nnz,
          "final_split_ms": final_ms,
          "tolerance_rel": TOLERANCE, "ops": ops, "bytes": nbytes,
          "achieved_gbps": nbytes / ms / 1e6, **row})
    return row


def phase_kernel_a_grouped(plan, x, reps) -> None:
    """Kernel A over the grouped layout (``group_cells=4``) of the last-hop
    operator: an index whose (panel, stripe) runs are padded with zero
    hole cells."""
    import numpy as np
    import torch

    from sgc_tpu_torch.ops import spmm_blockdense as bd

    R, W, F = 512, 512, int(x.shape[1])
    split = bd.split_block_dense(
        plan.graph_final, F, R, W, min_edges=plan.split_final.min_edges,
        super_rows=8, group_cells=4)
    dargs = bd.blockdense_device_args(split, x.device)
    got = bd.apply_cells(split, dargs, x, "f32")
    want = bd.apply_cells_plain(split, dargs, x, "f32")
    abs_err, err = rel_err(got, want)
    if not err <= TOLERANCE:
        raise AssertionError(f"kernel A (grouped) vs plain: {err:.3e}")
    del got, want
    ms = time_ms(lambda: bd.apply_cells(split, dargs, x, "f32"), reps)
    plain_ms = time_ms(
        lambda: bd.apply_cells_plain(split, dargs, x, "f32"), 1)
    # yardstick 1 (not the same function): the real cells' products as
    # one gathered f32 bmm
    real = np.flatnonzero(dargs.cells[: split.n_slots].flatten(1).any(1)
                          .cpu().numpy())
    xp = x.new_zeros((split.n_stripes * W, F))
    xp[: x.shape[0]] = x
    st = torch.as_tensor(split.st_ids[real], device=x.device).long()
    cells_f32 = dargs.cells[torch.as_tensor(real, device=x.device)].float()
    xg = xp.view(-1, W, F)[st]
    bmm_ms = time_ms(lambda: torch.bmm(cells_f32, xg), reps)
    del cells_f32, xg, xp
    # yardstick 2 (the same function as precision "f32"): the cells'
    # nonzero entries as one CSR matrix, torch.addmm
    csr = cells_csr(split, dargs, split.n_slots)
    zero = x.new_zeros((split.n_rows, F))
    library_ms = time_ms(lambda: torch.addmm(zero, csr, x, beta=0.0), reps)
    csr_nnz = int(csr._nnz())
    del csr, zero
    bound = kernel_a_bound(split, dargs, split.n_cells, F,
                           bd.n_passes("f32"))
    if bound["cell_nonzeros"] != csr_nnz:
        raise AssertionError("the grouped bound and its CSR yardstick count "
                             "different nonzeros")
    del dargs
    emit({"phase": "kernel_a_grouped", "group_cells": 4, "super_rows": 8,
          "precision": "f32", "passes": bd.n_passes("f32"),
          "cells": split.n_cells, "slots": split.n_slots,
          "nonzero_slots": len(real), "F": F, "max_abs_err": abs_err,
          "rel_err": err, "tolerance_rel": TOLERANCE, "ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "library": "torch.addmm, the cells' nonzeros as one CSR matrix "
                     f"({csr_nnz} entries): the same function as 'f32'",
          "bmm_f32_yardstick_ms": bmm_ms, **bound})


def csr_of(graph):
    """A torch CSR matrix of a graph on the card (yardsticks only)."""
    import torch

    nnz = graph.nnz
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        return torch.sparse_csr_tensor(
            graph.row_ptr, graph.cols[:nnz], graph.vals[:nnz],
            size=(graph.n_rows, graph.n_cols), check_invariants=False)


def phase_kernel_c(onehot, reps) -> dict:
    """Kernel C (the CSR kernel on the layout's edges re-sorted by row)
    through both entries (flat and stripe walk) on the onehot main split,
    against the plain version."""
    import numpy as np
    import torch

    from sgc_tpu_torch.ops import spmm_tiled as ti
    from sgc_tpu_torch.ops.spmm import spmm_segment

    plan, x = onehot["plan"], onehot["x"]
    split = plan.split_main
    tiled = split.tiled
    args_flat = plan._device_args()[0].tiled
    flat, walk = ti.flat_index(tiled), ti.stripe_index(tiled)
    if not all(np.array_equal(a, b) for a, b in zip(flat, walk)):
        raise AssertionError("the two chunk schedules disagree")
    # the plan's row index is the native one (built in prep); the stripe
    # entry runs on the numpy twin's, which must be the same arrays
    t0 = time.perf_counter()
    plain_index = ti.row_index_plain(tiled)
    plain_index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_index = ti.row_index(tiled)
    native_index_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(native_index,
                                                     plain_index)):
        raise AssertionError("kernel C's native and plain row index differ")
    args_walk = ti.tiled_device_args(tiled, x.device,
                                     ti.row_csr(tiled, plain_index))
    entries = {}
    for name, fn, dargs in (("flat", ti.spmm_tiled_flat, args_flat),
                            ("stripes", ti.spmm_tiled_stripes, args_walk)):
        got = fn(tiled, x, dargs)
        again = fn(tiled, x, dargs)
        want = ti.spmm_tiled_plain(tiled, x)
        abs_err, err = rel_err(got, want)
        if not err <= TOLERANCE:
            raise AssertionError(f"kernel C ({name}) vs plain: {err:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"kernel C ({name}): two launches differ")
        del got, again, want
        entries[name] = {
            "max_abs_err": abs_err, "rel_err": err,
            "ms": time_ms(lambda: fn(tiled, x, dargs), reps),
            "plain_ms": time_ms(
                lambda: ti.spmm_tiled_plain(tiled, x), 2)}
    del args_walk
    # the reference's precision="bf16" through the flat entry
    got = ti.spmm_tiled_flat(tiled, x, args_flat, "bf16")
    again = ti.spmm_tiled_flat(tiled, x, args_flat, "bf16")
    want = ti.spmm_tiled_plain(tiled, x, "bf16")
    bf16_abs_err, bf16_err = rel_err(got, want)
    if not bf16_err <= TOLERANCE:
        raise AssertionError(f"kernel C (flat, bf16) vs plain: "
                             f"{bf16_err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError("kernel C (flat, bf16): two launches differ")
    del got, again, want
    entries["flat_bf16"] = {
        "max_abs_err": bf16_abs_err, "rel_err": bf16_err,
        "ms": time_ms(lambda: ti.spmm_tiled_flat(tiled, x, args_flat,
                                                 "bf16"), reps),
        "plain_ms": time_ms(lambda: ti.spmm_tiled_plain(tiled, x, "bf16"),
                            2)}
    final = plan.split_final
    args_final = plan._device_args()[1].tiled
    final_ms = time_ms(
        lambda: ti.spmm_tiled_flat(final.tiled, x, args_final), reps)
    # the hop's other half: kernel B on each remainder, adding the dense
    # part in its epilogue
    rest_ms = {}
    for name, s, hargs in (("main", split, plan._device_args()[0]),
                           ("final", final, plan._device_args()[1])):
        if hargs.rest is not None:
            dense = ti.spmm_tiled_flat(s.tiled, x, hargs.tiled)
            rest_ms[name] = time_ms(
                lambda: spmm_segment(hargs.rest, x, dense), reps)
            del dense

    # yardstick: the dense part's slots as one coalesced CSR matrix
    # (duplicates and padding summed: the same operator), torch.addmm
    rows, cols, vals = (torch.as_tensor(a, device=x.device)
                        for a in (tiled.rows, tiled.cols, tiled.vals))
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]).long(), vals,
        (tiled.n_rows, tiled.n_cols)).coalesce()
    del rows, cols, vals
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse")
        csr = csr.to_sparse_csr()
    zero = x.new_zeros((tiled.n_rows, x.shape[1]))
    library_ms = time_ms(lambda: torch.addmm(zero, csr, x, beta=0.0), reps)
    del csr, zero

    F = int(x.shape[1])
    slots = int(tiled.rows.shape[0])
    edges = int(args_flat.cols.shape[0])
    ops = 2.0 * split.dense_edges * F
    # the edges' (col, val), the row pointer, x and out, once each
    nbytes = (edges * 8 + (tiled.n_rows + 1) * 4 + tiled.n_cols * F * 4
              + tiled.n_rows * F * 4)
    b_ms, b_by = bound_ms(ops, nbytes)
    row = {"name": "tiled_spmm", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/spmm_csr.cu",
           "replaces": "sgc_tpu/ops/spmm_pallas.py:169, :393",
           "precision": "f32",
           "launches": onehot["launches"]["tiled_spmm"],
           "max_abs_err": max(e["max_abs_err"] for e in entries.values()),
           "ms": entries["flat"]["ms"],
           "plain_ms": entries["flat"]["plain_ms"], "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms,
           "bf16_ms": entries["flat_bf16"]["ms"],
           "bf16_max_abs_err": entries["flat_bf16"]["max_abs_err"]}
    emit({"phase": "kernel_c", "kernel": "csr_spmm on the re-sorted layout",
          "slots": slots, "index_edges": edges,
          "row_index_native_s": native_index_s,
          "row_index_plain_s": plain_index_s,
          "dense_edges": split.dense_edges, "pad": split.pad, "F": F,
          "entries": entries, "final_split_slots":
          int(final.tiled.rows.shape[0]), "final_split_ms": final_ms,
          "remainder_nnz": {"main": split.sparse_edges,
                            "final": final.sparse_edges},
          "remainder_kernel_b_ms": rest_ms,
          "tolerance_rel": TOLERANCE, "ops": ops, "bytes": nbytes,
          "achieved_gbps": nbytes / entries["flat"]["ms"] / 1e6, **row})
    return row


def sddmm_bound(g, a, itemsize: int) -> tuple[float, str, float, float]:
    """Kernel D's bound at one operand width: 2 F flops per edge at the
    FP32 peak, against a and b read once each at ``itemsize`` bytes, the
    edges' rows and cols and the output."""
    F = int(a.shape[1])
    ops = 2.0 * g.nnz * F
    nbytes = ((g.n_rows + g.n_cols) * F * itemsize + g.nnz * 8
              + g.n_edges_padded * 4)
    return (*bound_ms(ops, nbytes), ops, nbytes)


def sddmm_on(g, a, b, reps, precisions) -> dict:
    """Kernel D through ``sddmm`` on one graph: its warps' segments, the
    runs of one row within them (one read of a's row each) and the bytes
    the kernel gathers, and per precision one counted call (counter zeroed
    just before, read just after), two launches equal bit for bit,
    padding 0, the error against the plain version, and the times of
    kernel, plain and library. The library call is
    ``torch.sparse.sampled_addmm`` in f32, at "bf16" on f32 copies of a
    and b rounded to bf16 (made outside the timed call): a product of two
    bf16 values is exact in f32, so it computes the same function."""
    import torch

    from sgc_tpu_torch.ops import spmm

    F, nnz = int(a.shape[1]), g.nnz
    rows = g.rows[:nnz]
    starts = torch.ones(nnz, dtype=torch.bool, device=a.device)
    starts[1:] = rows[1:] != rows[:-1]
    starts[::SDDMM_SEG] = True
    runs = int(starts.sum())
    out = {"nnz": nnz, "e_pad": g.n_edges_padded, "F": F,
           "edges_per_warp": SDDMM_SEG, "segments": -(-nnz // SDDMM_SEG),
           "row_runs": runs}
    csr = csr_of(g)
    for precision in precisions:
        spmm.SDDMM_LAUNCHES = 0
        got = spmm.sddmm(g, a, b, precision)
        torch.cuda.synchronize()
        launches = spmm.SDDMM_LAUNCHES
        if launches != 1:
            raise AssertionError(f"sddmm launched kernel D {launches} "
                                 "times")
        again = spmm.sddmm(g, a, b, precision)
        want = spmm.sddmm_plain(g, a, b, precision)
        abs_err, err = rel_err(got, want)
        if not err <= TOLERANCE:
            raise AssertionError(f"kernel D ({precision}) vs plain: "
                                 f"{err:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"kernel D ({precision}): two launches "
                                 "differ")
        if bool(got[nnz:].any()):
            raise AssertionError("kernel D wrote a padding slot")
        del got, again, want
        itemsize = 2 if precision == "bf16" else 4
        b_ms, b_by, ops, nbytes = sddmm_bound(g, a, itemsize)
        if precision == "bf16":
            ac, bct = spmm.bf16_round(a), spmm.bf16_round(b).t()
        else:
            ac, bct = a, b.t()
        library_ms = time_ms(
            lambda: torch.sparse.sampled_addmm(csr, ac, bct, beta=0.0), reps)
        del ac, bct
        ms = time_ms(lambda: spmm.sddmm(g, a, b, precision), reps)
        out[precision] = {
            "launches": launches, "max_abs_err": abs_err, "rel_err": err,
            "ms": ms,
            "plain_ms": time_ms(
                lambda: spmm.sddmm_plain(g, a, b, precision), 1),
            "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes,
            "gathered_b_bytes": nnz * F * itemsize,
            "a_row_bytes": runs * F * 4,
            "achieved_gbps": nbytes / ms / 1e6}
    return out


def phase_kernel_d(onehot, shuffled, reps) -> dict:
    """``sddmm`` over the whole main operator in the LPA order at both
    precisions and over the same graph in its shuffled order at "f32",
    each with two different operands (a = the features, b = one hop of
    them, so a kernel that swapped rows and cols would disagree)."""
    import torch

    from sgc_tpu_torch.ops import spmm

    g, a = onehot["graph"], onehot["x"]
    b = spmm.spmm_segment(g, a)
    lpa = sddmm_on(g, a, b, reps, ("f32", "bf16"))
    del b
    gs = shuffled[0].to(a.device)
    xs = torch.as_tensor(shuffled[1], device=a.device)
    shuffled_order = sddmm_on(gs, xs, spmm.spmm_segment(gs, xs), reps,
                              ("f32",))
    del gs, xs
    f32, bf16 = lpa["f32"], lpa["bf16"]
    row = {"name": "sddmm", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/sddmm.cu",
           "replaces": "sgc_tpu/ops/spmm_pallas.py:705",
           "precision": "f32", "launches": f32["launches"],
           "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
           "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
           "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
           "bf16_launches": bf16["launches"],
           "bf16_max_abs_err": bf16["max_abs_err"], "bf16_ms": bf16["ms"],
           "bf16_plain_ms": bf16["plain_ms"],
           "bf16_bound_ms": bf16["bound_ms"],
           "bf16_bound_by": bf16["bound_by"],
           "bf16_library_ms": bf16["library_ms"],
           "shuffled_order_ms": shuffled_order["f32"]["ms"]}
    emit({"phase": "kernel_d", "operands": "a = x, b = spmm_segment(graph, "
          "x)", "launches_note": "calls of sddmm; each is one CUDA launch "
          "after a memset of the padding", "tolerance_rel": TOLERANCE,
          "lpa_order": lpa, "shuffled_order": shuffled_order, **row})
    return row


def phase_dispatcher(onehot, reps) -> None:
    """``spmm(graph, x, impl=...)`` for every impl, each against kernel
    B's product; every impl must launch the kernels it stands for."""
    from sgc_tpu_torch.ops import spmm, spmm_blockdense, spmm_tiled
    from sgc_tpu_torch.utils.buildcache import clear_placed

    g, x = onehot["graph"], onehot["x"]
    expect = {"auto": ("csr_spmm",), "segment": ("csr_spmm",),
              "chunked": ("csr_spmm",), "tiled": ("tiled_spmm",),
              "hybrid": ("tiled_spmm", "csr_spmm"),
              "blockdense": ("blockdense_cells", "csr_spmm")}
    mods = {"csr_spmm": spmm, "tiled_spmm": spmm_tiled,
            "blockdense_cells": spmm_blockdense}
    ref = spmm.spmm_segment(g, x)
    impls = {}
    for impl in spmm.IMPLS:
        for mod in mods.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        out = spmm.spmm(g, x, impl=impl)
        first_s = time.perf_counter() - t0
        launches = {k: m.LAUNCHES for k, m in mods.items()}
        _, err = rel_err(out, ref)
        del out
        tol = BF16_TOLERANCE if impl == "blockdense" else TOLERANCE
        if not err <= tol:
            raise AssertionError(f"spmm(impl={impl!r}) vs kernel B: "
                                 f"{err:.3e} > {tol}")
        if any(launches[k] <= 0 for k in expect[impl]):
            raise AssertionError(f"spmm(impl={impl!r}) launched {launches}")
        impls[impl] = {"rel_err": err, "tolerance_rel": tol,
                       "first_call_s": first_s, "launches": launches,
                       "ms": time_ms(lambda: spmm.spmm(g, x, impl=impl),
                                     reps)}
    clear_placed()
    emit({"phase": "dispatcher", "impls": impls})


def counted(fn):
    """``(fn(), launches)``: every kernel's counter, by its row name in the
    kernels line, zeroed just before the call and read just after it (the
    card synchronized)."""
    import torch

    from sgc_tpu_torch.ops import spmm, spmm_blockdense, spmm_tiled

    counters = {"blockdense_cells": (spmm_blockdense, "LAUNCHES"),
                "csr_spmm": (spmm, "LAUNCHES"),
                "tiled_spmm": (spmm_tiled, "LAUNCHES"),
                "sddmm": (spmm, "SDDMM_LAUNCHES")}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(mod, attr)
                 for name, (mod, attr) in counters.items()}


def scratch_dir():
    """A temporary directory under the checkout's git-ignored build/."""
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build)


def phase_reddit_cli(args, device) -> dict:
    """The Reddit CLI's ``run(inductive=True, test=True)`` on a
    Reddit-format pair at Reddit's published shape (clustered recipe,
    GraphSAGE's split sizes), once on the plain path (``sgc_precompute``
    on both adjacencies: kernel B) and once with ``locality=True``
    (``LocalityPlan`` with the card's calibrated admission). The eval
    features of both paths must agree (1e-5 relative to max when no cell
    is admitted, the bf16 tolerance otherwise) and micro-F1 must beat 5x
    chance on each."""
    from sgc_tpu_torch.cli import reddit
    from sgc_tpu_torch.data.fixtures import write_reddit

    runs, launches = {}, {}
    with scratch_dir() as root:
        t0 = time.perf_counter()
        counts = write_reddit(root, scale=args.scale, seed=args.seed)
        write_s = time.perf_counter() - t0
        for name, locality in (("plain", False), ("locality", True)):
            t0 = time.perf_counter()
            runs[name], launches[name] = counted(lambda: reddit.run(
                data_path=root, inductive=True, test=True,
                locality=locality, seed=args.seed, device=device))
            runs[name]["wall_s"] = time.perf_counter() - t0
    plain, loc = runs["plain"], runs["locality"]
    dense = max(loc["dense_frac"], loc["train_dense_frac"])
    tol = TOLERANCE if dense == 0 else BF16_TOLERANCE
    abs_err, err = rel_err(loc["eval_features"], plain["eval_features"])
    shape = tuple(plain["eval_features"].shape)
    for r in runs.values():
        del r["eval_features"]
    chance = 1.0 / counts["classes"]
    emit({"phase": "reddit_cli", "fixture": counts, "write_s": write_s,
          "eval_shape": shape, "runs": runs, "launches": launches,
          "locality_vs_plain_max_abs_err": abs_err,
          "locality_vs_plain_rel_err": err, "tolerance_rel": tol,
          "chance": chance})
    if shape != (counts["nodes"], counts["features"]):
        raise AssertionError(f"eval features of shape {shape}")
    if not err <= tol:
        raise AssertionError(f"locality vs plain eval features: {err:.3e}")
    for name, r in runs.items():
        if not r["f1_micro"] > 5 * chance:
            raise AssertionError(f"{name}: micro-F1 {r['f1_micro']:.4f}")
    if launches["plain"]["csr_spmm"] <= 0 or (
            launches["locality"]["csr_spmm"] <= 0 and dense < 1):
        raise AssertionError(f"kernel B never launched: {launches}")
    if dense > 0 and launches["locality"]["blockdense_cells"] <= 0:
        raise AssertionError(f"cells admitted, kernel A idle: {launches}")
    return launches


def phase_citation_cli(args, device) -> dict:
    """The citation CLI at Pubmed's published shape on a Planetoid-format
    fixture: ``run()`` under each propagator and the K sweep, then
    ``sgc_precompute(degree=2)`` under every impl against ``segment``
    (1e-5; ``blockdense`` at its default bf16 x: the bf16 tolerance),
    each impl's kernels shown launched, and ``out_rows=idx_test`` equal
    bit for bit to the full result's rows."""
    import torch

    from sgc_tpu_torch.cli import citation, sweep
    from sgc_tpu_torch.data.fixtures import PUBMED, write_planetoid
    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.ops.propagate import sgc_precompute
    from sgc_tpu_torch.ops.spmm import IMPLS
    from sgc_tpu_torch.utils.config import CitationConfig

    runs, launches = {}, {}
    with scratch_dir() as root:
        write_planetoid(root, "pubmed", **PUBMED, seed=args.seed)
        for prop in ("sgc", "appnp", "ssgc"):
            runs[prop], launches[prop] = counted(lambda: citation.run(
                CitationConfig(dataset="pubmed", seed=args.seed), root,
                propagator=prop, device=device))
        rows, launches["sweep"] = counted(lambda: sweep.sweep(
            ["pubmed"], [1, 2, 3], seed=args.seed, data_path=root,
            device=device))
        data = load_citation("pubmed", data_path=root, device=device)
    chance = 1.0 / data.n_classes
    x, g = data.features, data.graph
    seg, _ = sgc_precompute(x, g, 2, impl="segment")
    expect = {"auto": ("csr_spmm",), "segment": ("csr_spmm",),
              "chunked": ("csr_spmm",), "tiled": ("tiled_spmm",),
              "hybrid": ("tiled_spmm", "csr_spmm"),
              "blockdense": ("blockdense_cells", "csr_spmm")}
    impls = {}
    for impl in IMPLS:
        (got, seconds), n = counted(lambda: sgc_precompute(x, g, 2, impl))
        _, err = rel_err(got, seg)
        tol = BF16_TOLERANCE if impl == "blockdense" else TOLERANCE
        (_, warm_s), _ = counted(lambda: sgc_precompute(x, g, 2, impl))
        impls[impl] = {"rel_err": err, "tolerance_rel": tol,
                       "first_s": seconds, "warm_s": warm_s, "launches": n}
        if not err <= tol:
            raise AssertionError(f"sgc_precompute({impl!r}) vs segment: "
                                 f"{err:.3e} > {tol}")
        if any(n[k] <= 0 for k in expect[impl]):
            raise AssertionError(f"sgc_precompute({impl!r}) launched {n}")
    sub, _ = sgc_precompute(x, g, 2, out_rows=data.idx_test)
    bits = bool(torch.equal(
        sub, seg[torch.as_tensor(data.idx_test, device=x.device)]))
    emit({"phase": "citation_cli", "fixture": {
              **PUBMED, "nnz_normalized": g.nnz}, "runs": runs,
          "sweep": rows, "launches": launches, "sgc_precompute": impls,
          "out_rows_bit_equal": bits, "chance": chance})
    if not bits:
        raise AssertionError("out_rows rows differ from the full result's")
    for name, r in runs.items():
        if not r["test_accuracy"] > 2 * chance:
            raise AssertionError(f"{name}: test accuracy "
                                 f"{r['test_accuracy']:.4f}")
    if any(r["test_acc"] <= 2 * chance for r in rows):
        raise AssertionError(f"sweep accuracies: {rows}")
    if any(n["csr_spmm"] <= 0 for n in launches.values()):
        raise AssertionError(f"kernel B never launched: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of Reddit's nodes and edges (1.0 = full)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import sgc_tpu_torch  # noqa: F401
    except ImportError:
        log("chip_smoke: run from a checkout of the repository")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_calibrate(device)
    main = phase_main_path(args, device)
    data = main.pop("data")
    phase_calibrated_path(data, main.pop("tr"), device)
    onehot = phase_onehot_path(data, device)
    shuffled = data[:2]
    del data
    rows = [phase_kernel_a(main["plan"], main["x"], main["launches"],
                           args.reps)]
    phase_kernel_a_grouped(main["plan"], main["x"], args.reps)
    rows.append(phase_kernel_b(main["plan"], main["x"], main["launches"],
                               args.reps))
    del main
    rows.append(phase_kernel_c(onehot, args.reps))
    rows.append(phase_kernel_d(onehot, shuffled, args.reps))
    del shuffled
    phase_dispatcher(onehot, args.reps)
    del onehot
    by_path = {"reddit_cli": phase_reddit_cli(args, device),
               "citation_cli": phase_citation_cli(args, device)}
    for row in rows:
        row["launches_by_path"] = {
            path: {run: n[row["name"]] for run, n in runs.items()}
            for path, runs in by_path.items()}
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
