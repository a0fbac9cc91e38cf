"""The system under test for SGC configurations: whole fits of the
port's main path in a closed loop.

Set-up: the graph from the traffic's draw and ``--seed`` (graphgen.py),
handed to the port as a ``SparseGraph``; the kernels built or loaded;
``LocalityPlan.build`` with the traffic's plan options (host clock,
``plan_build_s``); the features placed; the head's initial weights drawn
on the device from the seed; two warm fits.

A step is one fit: ``LocalityPlan.khop_traceable(degree)`` over the
placed features, then ``train_linear(trainer="newton")``, which closes
with a synchronize. Phases: ``hops``, ``head``.

After the window: the last fit's propagated rows, and the heads of the
last fit and of a sample of the window's fits drawn from the seed
(:data:`SAMPLE` of the first :data:`SAMPLE_FROM`; kept as they come, so
that keeping them allocates nothing each fit), are held against the
plain reference (reference/sgc.py) in float64: ``prop_err`` (the worst
gap of a propagated train row's entry, over the largest entry) and
``head_err`` (the worst kept head's ``||theta - theta_ref|| /
||theta_ref||`` over weights and bias).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import graphgen
from portbench.record import (Check, Phases, RunRecord, log,
                              release_program, timed_loop)

SAMPLE, SAMPLE_FROM = 32, 512   # the window's fits whose heads are kept


def init_head(seed: int, n_features: int, n_classes: int, device):
    """``(w, b)`` drawn uniform in ``+-1/sqrt(F)`` (``nn.Linear``'s rule)
    in one call on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    bound = 1.0 / math.sqrt(n_features)
    flat = torch.empty((n_features + 1) * n_classes, device=device)
    flat.uniform_(-bound, bound, generator=gen)
    theta = flat.view(n_features + 1, n_classes)
    return theta[:-1].clone(), theta[-1].clone()


def work_counts(csr, idx_train: np.ndarray, n_features: int,
                n_classes: int, degree: int, steps: int) -> dict:
    """One fit's sizes, from the benchmark's own operator: the full
    hops' and the train-row hop's edges and used columns."""
    final = csr[idx_train]
    return {"n": csr.shape[0], "nnz": int(csr.nnz),
            "used_cols": int(np.unique(csr.indices).size),
            "n_train": len(idx_train), "nnz_final": int(final.nnz),
            "used_cols_final": int(np.unique(final.indices).size),
            "features": n_features, "classes": n_classes, "degree": degree,
            "newton_steps": steps}


def prop_gap(rows: torch.Tensor, p_ref: torch.Tensor, pos=None) -> float:
    """The worst entry gap of propagated rows (``rows[i]`` is the
    reference's row ``pos[i]``), over the reference's largest entry."""
    want = p_ref if pos is None else p_ref[pos]
    return float((rows.to(p_ref.dtype) - want).abs().max()
                 / p_ref.abs().max())


def head_gap(theta: torch.Tensor, theta_ref: torch.Tensor) -> float:
    """``||theta - theta_ref|| / ||theta_ref||`` over weights and bias."""
    return float((theta.to(theta_ref.dtype) - theta_ref).norm()
                 / theta_ref.norm())


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, process_start: float) -> RunRecord:
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models.sgc import SGC
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.train.loops import train_linear

    from portbench import trace as tr
    from portbench.reference import sgc as ref

    rec = RunRecord(config=config)
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    shape, head = config["shape"], config["head"]
    degree, wd, steps = config["degree"], head["weight_decay"], head["steps"]

    t0 = time.perf_counter()
    log(f"set-up starts at {t0 - process_start:.2f} s")
    data = graphgen.generate(shape, traffic["graph"], seed)
    csr = graphgen.normalized(data)
    graph = SparseGraph.from_scipy(csr)
    log(f"graph {data.n} nodes, {csr.nnz} entries: "
        f"{time.perf_counter() - t0:.2f} s")
    rec.counts = work_counts(csr, data.idx_train, data.features.shape[1],
                             data.n_classes, degree, steps)
    del csr
    kernels.load_all(device)
    log(f"kernels loaded at {time.perf_counter() - process_start:.2f} s")
    t0 = time.perf_counter()
    plan = LocalityPlan.build(graph, data.features, data.labels,
                              data.idx_train, device=device,
                              **traffic["plan"])
    rec.setup_spans["plan_build_s"] = time.perf_counter() - t0
    log(f"plan {plan.formulation}, dense fraction {plan.dense_fraction}, "
        f"{rec.setup_spans['plan_build_s']:.2f} s {plan.prep_seconds}")
    rows_orig = plan.order[plan.idx_train]   # the program's row -> node id
    x = torch.as_tensor(plan.features, device=device)
    y = torch.as_tensor(plan.labels[plan.idx_train], device=device).long()
    w0, b0 = init_head(seed, data.features.shape[1], data.n_classes, device)
    model = SGC(w0.clone(), b0.clone())
    khop, args = plan.khop_traceable(degree=degree,
                                     precision=config["precision"])
    del graph

    sample = set(np.random.default_rng(seed).choice(
        SAMPLE_FROM, SAMPLE, replace=False).tolist())
    heads, last = [], {"fits": 0}

    def step(phase):
        with phase("hops"):
            rows = khop(x, args)
        with phase("head"):
            fit, _ = train_linear(model, rows, y, weight_decay=wd,
                                  trainer=head["trainer"],
                                  newton_steps=steps)
        if last["fits"] in sample:
            heads.append(fit)
        last.update(rows=rows, fit=fit, fits=last["fits"] + 1)

    for _ in range(2):      # warm: two fits, so that the window's first
        step(Phases())      # finds the last fit's buffers to alternate with
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    heads.clear()
    last["fits"] = 0
    rec.setup_s = time.perf_counter() - process_start
    log(f"set-up {rec.setup_s:.2f} s")
    timed_loop(step, seconds, rec, device, events=trace)
    log(f"window {rec.window_s:.3f} s, {rec.steps} fits")
    if trace and device.type == "cuda":
        n = traffic["trace_steps"]
        rec.trace = tr.profile_steps(step, n, lambda: Phases(annotate=True))
    if device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    # the program's state goes before the reference runs
    rows = last.pop("rows")
    heads.append(last.pop("fit"))
    del plan, khop, args, x, model
    release_program(device)
    t0 = time.perf_counter()
    p_ref = ref.propagate(data.src, data.dst, data.n, data.features,
                          data.idx_train, degree, device)
    pos = torch.as_tensor(np.searchsorted(data.idx_train, rows_orig),
                          device=device)
    prop_err = prop_gap(rows, p_ref, pos)
    del rows, pos
    labels = torch.as_tensor(data.labels[data.idx_train], device=device)
    theta0 = torch.cat([w0, b0[None]]).to(p_ref.dtype)
    theta_ref, _ = ref.newton_head(p_ref, labels, theta0, wd, steps)
    errs = torch.tensor([head_gap(torch.cat([h.w, h.b[None]]), theta_ref)
                         for h in heads])
    log(f"reference {time.perf_counter() - t0:.2f} s")
    limits = config["limits"]
    rec.failed = int((~(errs <= limits["head_err"])).sum())
    rec.checks = [Check("prop_err", prop_err, limits["prop_err"]),
                  Check("head_err", float(errs.max()), limits["head_err"])]
    return rec
