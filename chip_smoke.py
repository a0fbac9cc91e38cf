#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``sgc_tpu_torch``) on one card.

    python3 chip_smoke.py [--scale 1.0] [--seed 42] [--reps 5]

Drives the port's main path once at full model width (F = 602, 41
classes, 512 x 512 cells, K = 2 hops, 8 Newton steps), the clustered
Reddit-shaped SGC pipeline:

    synthetic_reddit_clustered(scale, shuffle=True)
    -> LocalityPlan.build(formulation="auto")      (LPA order + splits)
    -> khop_traceable(degree=2)                    (kernel A + kernel B)
    -> _newton_linear_fit(steps=8), gated against the LBFGS oracle

then runs the same hops under the admission rates measured on the card
(``calibrate=True``), and holds each CUDA kernel against its plain
PyTorch version on the main path's own inputs. Phases print one JSON line each on stdout; the line
before the last is ``{"kernels": [...]}`` and the last is
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
# tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
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


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_FP32_FLOPS
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


def phase_main_path(args, device) -> dict:
    import torch

    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.models.sgc import init_sgc
    from sgc_tpu_torch.ops import spmm, spmm_blockdense
    from sgc_tpu_torch.train.loops import (
        _lbfgs_linear_fit,
        _newton_linear_fit,
    )
    from sgc_tpu_torch.utils.profiling import sync

    spmm_blockdense.LAUNCHES = 0
    spmm.LAUNCHES = 0
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

    x = torch.as_tensor(plan.features, device=device)
    n_classes = int(plan.labels.max()) + 1
    params0 = init_sgc(torch.Generator().manual_seed(42), x.shape[1],
                       n_classes, device=device)
    y = torch.as_tensor(plan.labels[plan.idx_train], device=device).long()
    cw = torch.ones(n_classes, device=device)
    khop, dev_args = plan.khop_traceable(degree=2)

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
    launches = {"blockdense_cells": spmm_blockdense.LAUNCHES,
                "csr_spmm": spmm.LAUNCHES}
    edges = plan.graph.nnz + plan.graph_final.nnz

    # the propagated rows against the plain formulation on the card
    (a_main, a_final) = dev_args
    plain_tr = spmm_blockdense.spmm_block_dense(
        plan.split_final,
        spmm_blockdense.spmm_block_dense(plan.split_main, x, a_main),
        a_final)
    if tuple(tr.shape) != (len(plan.idx_train), x.shape[1]):
        raise AssertionError(f"propagated shape {tuple(tr.shape)}")
    abs_err, err = rel_err(tr, plain_tr)
    if not err <= TOLERANCE:
        raise AssertionError(f"propagation vs plain: rel err {err:.3e}")
    del plain_tr

    parity = train_parity(tr, y, params0, cw, _newton_linear_fit,
                          _lbfgs_linear_fit)
    emit({"phase": "main_path", "formulation": plan.formulation,
          "calibrate": False, "min_edges": s.min_edges,
          "dense_frac": plan.dense_fraction,
          "cells_main": s.n_cells, "cells_final": plan.split_final.n_cells,
          "sparse_edges_main": s.sparse_edges,
          "cell_gb": (s.cell_bytes + plan.split_final.cell_bytes) / 1e9,
          "prep_s": prep_s, "prep_stages": plan.prep_seconds,
          "warm_s": warm_s, "total_s": total_s, "hops_s": hops_s,
          "edges": edges, "edges_per_s": edges / hops_s,
          "launches": launches, "propagation_max_abs_err": abs_err,
          "propagation_rel_err": err, "train_parity": parity})
    if not parity["parity_ok"]:
        raise AssertionError(f"train parity failed: {parity}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"plan": plan, "x": x, "launches": launches,
            "data": (graph, features, labels, idx_train), "tr": tr}


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
    khop, dev_args = plan.khop_traceable(degree=2)
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
    emit({"phase": "calibrated_path", "min_edges": plan.split_main.min_edges,
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


def phase_kernel_a(plan, x, launches, reps) -> dict:
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
        got = bd.apply_cells(split, dargs, x)
        want = bd.apply_cells_plain(split, dargs, x)
        abs_err, err = rel_err(got, want)
        if not err <= TOLERANCE:
            raise AssertionError(f"kernel A ({name}) vs plain: {err:.3e}")
        del got, want
        orders[name] = {
            "max_abs_err": abs_err, "rel_err": err,
            "ms": time_ms(lambda: bd.apply_cells(split, dargs, x), reps),
            "plain_ms": time_ms(
                lambda: bd.apply_cells_plain(split, dargs, x), 2)}
    del args_classic
    ms = orders["super_rows_8"]["ms"]
    plain_ms = orders["super_rows_8"]["plain_ms"]
    # the last hop's split (train rows only), for the hop-time breakdown
    args_final = plan._device_args()[1]
    final_ms = time_ms(
        lambda: bd.apply_cells(plan.split_final, args_final, x), reps)

    # yardstick: one gathered f32 bmm of every cell against its stripe
    # (the per-cell products, without the row-block sum)
    n_real = split_super.n_cells
    xp = x.new_zeros((split_super.n_stripes * W, F))
    xp[: x.shape[0]] = x
    st = torch.as_tensor(split_super.st_ids[:n_real], device=x.device).long()
    cells_f32 = args_super.cells[:n_real].float()
    xg = xp.view(-1, W, F)[st]
    library_ms = time_ms(lambda: torch.bmm(cells_f32, xg), reps)
    del cells_f32, xg, xp

    ops = 2.0 * R * W * F * n_real
    nbytes = (n_real * R * W * 2 + split_super.n_cols * F * 4
              + split_super.n_rows * F * 4
              + (split_super.n_row_blocks + 1 + 2 * n_real) * 4)
    b_ms, b_by = bound_ms(ops, nbytes)
    row = {"name": "blockdense_cells", "route": "cuda",
           "source": "sgc_tpu_torch/csrc/blockdense.cu",
           "replaces": "sgc_tpu/ops/spmm_blockdense.py:353",
           "launches": launches["blockdense_cells"],
           "max_abs_err": max(o["max_abs_err"] for o in orders.values()),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms}
    emit({"phase": "kernel_a", "cells": n_real, "F": F, "orders": orders,
          "final_split_cells": plan.split_final.n_cells,
          "final_split_ms": final_ms,
          "tolerance_rel": TOLERANCE, "ops": ops, "bytes": nbytes,
          "achieved_tflops": ops / ms / 1e9, **row})
    return row


def phase_kernel_b(plan, x, launches, reps) -> dict:
    import numpy as np
    import torch

    from sgc_tpu_torch.ops import spmm_blockdense as bd
    from sgc_tpu_torch.ops.spmm import spmm_segment, spmm_segment_plain

    split = plan.split_main
    dargs = plan._device_args()[0]
    rest = dargs.rest
    dense = bd.apply_cells(split, dargs, x)
    got = spmm_segment(rest, x, dense)
    want = spmm_segment_plain(rest, x, dense)
    abs_err, err = rel_err(got, want)
    if not err <= TOLERANCE:
        raise AssertionError(f"kernel B vs plain: {err:.3e}")
    del got, want
    ms = time_ms(lambda: spmm_segment(rest, x, dense), reps)
    plain_ms = time_ms(lambda: spmm_segment_plain(rest, x, dense), 2)
    args_final = plan._device_args()[1]
    dense_final = bd.apply_cells(plan.split_final, args_final, x)
    final_ms = time_ms(
        lambda: spmm_segment(args_final.rest, x, dense_final), reps)
    nnz = rest.nnz
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Sparse CSR tensor")
        csr = torch.sparse_csr_tensor(rest.row_ptr, rest.cols[:nnz],
                                      rest.vals[:nnz],
                                      size=(rest.n_rows, rest.n_cols),
                                      check_invariants=False)
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
    phase_calibrated_path(main.pop("data"), main.pop("tr"), device)
    rows = [phase_kernel_a(main["plan"], main["x"], main["launches"],
                           args.reps),
            phase_kernel_b(main["plan"], main["x"], main["launches"],
                           args.reps)]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
