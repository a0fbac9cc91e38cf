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
B's CUDA kernel on the tiled layout's edges re-sorted by row), kernel D
through ``sddmm`` on the main operator with two different operands),
checks that kernels A and C give identical bits across two launches, and
drives ``spmm(impl=...)`` for every impl. Phases
print one JSON line each on stdout; the line before the last is
``{"kernels": [...]}`` and the last is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no result; so does a run without a CUDA device
or outside the repository.
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


def cells_csr(split, dargs, n_real):
    """The real cells' nonzero entries (their bf16 values, widened) as one
    CSR matrix on the card: kernel A's function at precision "f32" as a
    sparse matrix (yardstick only)."""
    import torch

    R, W = split.row_block, split.stripe
    cells = dargs.cells[:n_real]
    k, r, w = cells.nonzero(as_tuple=True)
    rb = torch.as_tensor(split.rb_ids[:n_real], device=cells.device)
    st = torch.as_tensor(split.st_ids[:n_real], device=cells.device)
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
    # yardstick: the real cells' products as one gathered f32 bmm
    real = np.flatnonzero(dargs.cells[: split.n_slots].flatten(1).any(1)
                          .cpu().numpy())
    xp = x.new_zeros((split.n_stripes * W, F))
    xp[: x.shape[0]] = x
    st = torch.as_tensor(split.st_ids[real], device=x.device).long()
    cells_f32 = dargs.cells[torch.as_tensor(real, device=x.device)].float()
    xg = xp.view(-1, W, F)[st]
    library_ms = time_ms(lambda: torch.bmm(cells_f32, xg), reps)
    del cells_f32, xg, xp
    bound = kernel_a_bound(split, dargs, split.n_cells, F,
                           bd.n_passes("f32"))
    del dargs
    emit({"phase": "kernel_a_grouped", "group_cells": 4, "super_rows": 8,
          "precision": "f32", "passes": bd.n_passes("f32"),
          "cells": split.n_cells, "slots": split.n_slots,
          "nonzero_slots": len(real), "F": F, "max_abs_err": abs_err,
          "rel_err": err, "tolerance_rel": TOLERANCE, "ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms, **bound})


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
           "launches": onehot["launches"]["tiled_spmm"],
           "max_abs_err": max(e["max_abs_err"] for e in entries.values()),
           "ms": entries["flat"]["ms"],
           "plain_ms": entries["flat"]["plain_ms"], "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms}
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


def phase_kernel_d(onehot, reps) -> dict:
    """``sddmm`` over the whole main operator with two different operands
    (a = the reordered features, b = one hop of them, so a kernel that
    swapped rows and cols would disagree): the entry point run once with
    its counter zeroed, then held against the plain version."""
    import torch

    from sgc_tpu_torch.ops import spmm

    g, a = onehot["graph"], onehot["x"]
    b = spmm.spmm_segment(g, a)
    spmm.SDDMM_LAUNCHES = 0
    got = spmm.sddmm(g, a, b)
    torch.cuda.synchronize()
    launches = spmm.SDDMM_LAUNCHES
    if launches != 1:
        raise AssertionError(f"sddmm launched kernel D {launches} times")
    want = spmm.sddmm_plain(g, a, b)
    abs_err, err = rel_err(got, want)
    if not err <= TOLERANCE:
        raise AssertionError(f"kernel D vs plain: {err:.3e}")
    if bool(got[g.nnz:].any()):
        raise AssertionError("kernel D wrote a padding slot")
    del got, want
    ms = time_ms(lambda: spmm.sddmm(g, a, b), reps)
    plain_ms = time_ms(lambda: spmm.sddmm_plain(g, a, b), 1)
    csr = csr_of(g)
    bt = b.t()
    library_ms = time_ms(
        lambda: torch.sparse.sampled_addmm(csr, a, bt, beta=0.0), reps)
    del csr, bt, b
    F = int(a.shape[1])
    ops = 2.0 * g.nnz * F
    # a and b read once each, rows and cols of every edge, out written
    nbytes = 2 * a.numel() * 4 + g.nnz * 8 + g.n_edges_padded * 4
    b_ms, b_by = bound_ms(ops, nbytes)
    row = {"name": "sddmm", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/sddmm.cu",
           "replaces": "sgc_tpu/ops/spmm_pallas.py:705",
           "launches": launches, "max_abs_err": abs_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms}
    emit({"phase": "kernel_d", "nnz": g.nnz, "e_pad": g.n_edges_padded,
          "F": F, "operands": "a = x, b = spmm_segment(graph, x)",
          "rel_err": err, "tolerance_rel": TOLERANCE, "ops": ops,
          "bytes": nbytes, "achieved_gbps": nbytes / ms / 1e6, **row})
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
    del data
    rows = [phase_kernel_a(main["plan"], main["x"], main["launches"],
                           args.reps)]
    phase_kernel_a_grouped(main["plan"], main["x"], args.reps)
    rows.append(phase_kernel_b(main["plan"], main["x"], main["launches"],
                               args.reps))
    del main
    rows.append(phase_kernel_c(onehot, args.reps))
    rows.append(phase_kernel_d(onehot, args.reps))
    phase_dispatcher(onehot, args.reps)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
