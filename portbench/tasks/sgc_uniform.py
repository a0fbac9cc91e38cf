"""The system under test for SGC fits on the uniform graph: whole fits of
``sgc_precompute`` and the Newton head in a closed loop, with the
locality plan bypassed. Its cell, ``sgc-reddit.fit-uniform``, is not in
``BENCHMARK.json`` yet; portbench/tests/test_uniform_cell.py holds the
entry that adds it.

The graph is a frozen numpy copy of the port's uniform Reddit-shape draw
(``sgc_tpu_torch/data/synthetic.py::synthetic_reddit``): squared-uniform
row skew, uniform columns, ``A + A^T + I``, the original stream draw for
draw, so one seed gives one graph whatever later changes do to the
program. The train rows are the first ones, as there. The traffic's
``graph`` names it (``kind`` ``uniform``) and gives its ``scale``.

Set-up: the graph from the traffic's draw and ``--seed``, placed as a
``SparseGraph``; the kernels built or loaded; the features placed; the
head's initial weights drawn on the device from the seed
(tasks/sgc.py::init_head); two warm fits, the first of which builds the
train rows' subgraph that every fit's last hop reads.

A step is one fit: ``sgc_precompute(impl="segment",
out_rows=idx_train)`` over the placed features (kernel B gathering rows
at random, the last hop over the train rows only; it closes with a
synchronize), then ``train_linear(trainer="newton")``, which closes with
a synchronize. Phases: ``hops``, ``head``.

After the window the fits are held against the plain reference
(reference/sgc.py) in float64: ``prop_err`` on the last fit's propagated
train rows, as tasks/sgc.py holds them, and ``head_loss_gap`` on the
heads of the last fit and of a sample of the window's fits: the worst
kept head's ``|L(theta) - L(theta_ref)| / L(theta_ref)``, ``L`` the
reference's head loss on its own propagated rows.

Why the loss and not the weights (``head_err``): the draw's labels are
uniform noise, so in the Newton fit's last steps the loss over the step
grid is flat to a few parts in 10^8 of itself, below what float32 tells
apart. The program then breaks those ties otherwise than the float64
reference (another step of the grid, a step of 0 or 16), which moves the
weights by up to a few parts in 10^3 while the loss stays where the
reference's is; the reference fed the program's own propagated rows takes
the reference's steps to 1.5e-7. So the float32 arithmetic of the head,
not its input rows, breaks the ties, and the program's weights lie as far
from the float64 head on the program's rows as from the reference's: no
weight check holds here. The weights are not determined by the fit to
float32's precision here; the loss is. ``head_loss_gap``'s limit is the
traffic file's ``limits``, ``prop_err``'s the configuration's.

What this cell does not guard: the head's precision. A head in TF32
lands on the same flat loss (the control's ``head_loss_gap`` lies below
the program's), so only ``prop_err`` fails the control here; the
clustered cell's ``head_err`` guards the head's precision.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import graphgen, spec
from portbench.record import (Check, Phases, RunRecord, log,
                              release_program, timed_loop)


def uniform(shape: dict, seed: int, scale: float = 1.0
            ) -> graphgen.GraphData:
    """Sources squared-uniform over the ids (hubs at the low ids),
    destinations uniform; Gaussian features and uniform labels; the
    first ``train`` rows are the train rows."""
    n = max(int(shape["nodes"] * scale), 1024)
    e = max(int(shape["edges"] * scale), 4096)
    n_feat, n_cls = int(shape["features"]), int(shape["classes"])
    rng = np.random.default_rng(seed)
    src = (rng.random(e // 2) ** 2 * n).astype(np.int64) % n
    dst = rng.integers(0, n, e // 2)
    features = rng.normal(size=(n, n_feat)).astype(np.float32)
    labels = rng.integers(0, n_cls, n).astype(np.int32)
    n_train = min(max(int(shape["train"] * scale), 256), n)
    return graphgen.GraphData(src, dst, features, labels,
                              np.arange(n_train, dtype=np.int64), n, n_cls)


def generate(shape: dict, graph: dict, seed: int) -> graphgen.GraphData:
    """The draw that the traffic's ``graph`` names, at ``shape``."""
    if graph["kind"] != "uniform":
        raise ValueError(f"this task draws the uniform graph, not "
                         f"{graph['kind']!r}")
    return uniform(shape, seed, graph.get("scale", 1.0))


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, process_start: float) -> RunRecord:
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models.sgc import SGC
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops.propagate import sgc_precompute
    from sgc_tpu_torch.train.loops import train_linear

    from portbench import trace as tr
    from portbench.reference import sgc as ref

    sgc = spec.task("sgc")
    rec = RunRecord(config=config)
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    shape, head = config["shape"], config["head"]
    degree, wd, steps = config["degree"], head["weight_decay"], head["steps"]

    t0 = time.perf_counter()
    log(f"set-up starts at {t0 - process_start:.2f} s")
    data = generate(shape, traffic["graph"], seed)
    csr = graphgen.normalized(data)
    graph = SparseGraph.from_scipy(csr).to(device)
    log(f"graph {data.n} nodes, {csr.nnz} entries: "
        f"{time.perf_counter() - t0:.2f} s")
    rec.counts = sgc.work_counts(csr, data.idx_train, data.features.shape[1],
                                 data.n_classes, degree, steps)
    del csr
    kernels.load_all(device)
    log(f"kernels loaded at {time.perf_counter() - process_start:.2f} s")
    x = torch.as_tensor(data.features, device=device)
    y = torch.as_tensor(data.labels[data.idx_train], device=device).long()
    w0, b0 = sgc.init_head(seed, data.features.shape[1], data.n_classes,
                           device)
    model = SGC(w0.clone(), b0.clone())
    idx_train = data.idx_train

    sample = set(np.random.default_rng(seed).choice(
        sgc.SAMPLE_FROM, sgc.SAMPLE, replace=False).tolist())
    heads, last = [], {"fits": 0}

    def step(phase):
        with phase("hops"):
            rows, _ = sgc_precompute(x, graph, degree, impl="segment",
                                     out_rows=idx_train)
        with phase("head"):
            fit, _ = train_linear(model, rows, y, weight_decay=wd,
                                  trainer=head["trainer"],
                                  newton_steps=steps)
        if last["fits"] in sample:
            heads.append(fit)
        last.update(rows=rows, fit=fit, fits=last["fits"] + 1)

    for _ in range(2):      # warm: two fits (the first builds the train
        step(Phases())      # rows' subgraph)
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
    del graph, x, model
    release_program(device)
    t0 = time.perf_counter()
    p_ref = ref.propagate(data.src, data.dst, data.n, data.features,
                          data.idx_train, degree, device)
    prop_err = sgc.prop_gap(rows, p_ref)
    del rows
    labels = torch.as_tensor(data.labels[data.idx_train], device=device)
    theta0 = torch.cat([w0, b0[None]]).to(p_ref.dtype)
    theta_ref, _ = ref.newton_head(p_ref, labels, theta0, wd, steps)
    errs = torch.tensor([
        head_loss_gap(p_ref, labels, torch.cat([h.w, h.b[None]]), theta_ref,
                      wd) for h in heads])
    log(f"reference {time.perf_counter() - t0:.2f} s")
    limits = {**config["limits"], **traffic["limits"]}
    rec.failed = int((~(errs <= limits["head_loss_gap"])).sum())
    rec.checks = [Check("prop_err", prop_err, limits["prop_err"]),
                  Check("head_loss_gap", float(errs.max()),
                        limits["head_loss_gap"])]
    return rec


def head_loss_gap(p_ref: torch.Tensor, labels: torch.Tensor,
                  theta: torch.Tensor, theta_ref: torch.Tensor,
                  weight_decay: float) -> float:
    """``|L(theta) - L(theta_ref)| / L(theta_ref)``, ``L`` the reference's
    head loss (reference/sgc.py::head_loss) on the rows ``p_ref``."""
    from portbench.reference import sgc as ref

    want = ref.head_loss(p_ref, labels, theta_ref, weight_decay)
    got = ref.head_loss(p_ref, labels, theta.detach().to(p_ref.dtype),
                        weight_decay)
    return float((got - want).abs() / want.abs())


def upper(config: dict, traffic: dict, seed: int, device) -> dict:
    """The upper readings of ``portbench.control_cells`` for this cell on
    one seed, as ``portbench.control`` takes them for the clustered cell:
    the control (the reference in TF32) and the faults (the head
    returned unchanged, the head fitted on half of the train rows, one
    propagated row replaced by another's), each held against the float64
    reference as a run holds the program."""
    from portbench.reference import sgc as ref

    sgc = spec.task("sgc")
    head, degree = config["head"], config["degree"]
    wd, steps = head["weight_decay"], head["steps"]
    d = generate(config["shape"], traffic["graph"], seed)
    w0, b0 = sgc.init_head(seed, d.features.shape[1], d.n_classes, device)
    theta0 = torch.cat([w0, b0[None]]).double()
    labels = torch.as_tensor(d.labels[d.idx_train], device=device)
    p64 = ref.propagate(d.src, d.dst, d.n, d.features, d.idx_train, degree,
                        device)
    theta_ref, _ = ref.newton_head(p64, labels, theta0, wd, steps)
    p32 = ref.propagate(d.src, d.dst, d.n, d.features, d.idx_train, degree,
                        device, "tf32")
    theta_c, _ = ref.newton_head(p32, labels, theta0, wd, steps, "tf32")
    out = {"control": {"prop_err": sgc.prop_gap(p32, p64),
                       "head_loss_gap": head_loss_gap(p64, labels, theta_c,
                                                      theta_ref, wd)}}
    del p32
    theta_h, _ = ref.newton_head(p64[::2], labels[::2], theta0, wd, steps)
    moved = p64.clone()
    moved[0] = p64[1]
    out["faults"] = {
        "unchanged": {"head_loss_gap": head_loss_gap(
            p64, labels, theta0, theta_ref, wd)},
        "half_batch": {"head_loss_gap": head_loss_gap(
            p64, labels, theta_h, theta_ref, wd)},
        "altered_row": {"prop_err": sgc.prop_gap(moved, p64)}}
    return out
