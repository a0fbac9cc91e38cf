"""The system under test for GCNII configurations: full-batch training
steps in a closed loop.

Set-up builds one training object: the graph from the traffic's draw and
``--seed`` placed as a ``SparseGraph``, the prescaled operator ``(1 -
alpha) S`` (``models/gcnii.py::scaled_operator``, which builds the
transpose and caches its values for the backward), the features, the
train rows' target (``train/loops.py::train_target``), the model from
weights drawn on the device from the seed (:func:`init_leaves`), and
``torch.optim.Adam`` with the authors' two parameter groups (the conv
weights at ``weight_decay.conv``, the dense layers at
``weight_decay.dense``). It drives that object through the traffic's
``first_steps`` steps with the window's own step function and keeps what
the comparison needs: the first step's logits of the train rows and its
gradient of every compared leaf (read after the backward, before Adam's
update), each of those steps' loss, and the parameters after the steps.
The window goes on with the same object.

A step: ``gcnii_apply`` (64 layers, each one launch of kernel B with the
initial residual added in it, then the identity mapping's product),
``node_cross_entropy``, ``backward()`` (kernel B over the cached
transpose a layer), ``Adam.step()``, closed by a synchronize. Phases:
``forward``, ``backward``, ``optimizer``.

After the window the plain reference (reference/gcnii.py) follows the
same first steps in float64 from the same weights. The compared leaves
are ``w_in``, ``b_in``, each layer's conv weight, ``w_out`` and
``b_out``; ``loss_gap``, ``grad_gap``, ``change_gap`` and ``logit_gap``
are reckoned as the GAT cell's (tasks/gat.py::gaps).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import graphgen, spec
from portbench.record import (Check, Phases, RunRecord, log,
                              release_program, timed_loop)

LEAVES = ("w_in", "b_in", "w_conv", "w_out", "b_out")


def leaf_shapes(config: dict, n_features: int, n_classes: int) -> dict:
    """Each leaf's shape and the bound of its uniform draw: the conv
    weights ``+-1/sqrt(H)`` (the authors' rule), the dense layers
    ``+-1/sqrt(fan_in)`` (``nn.Linear``'s)."""
    h, layers = config["hidden"], config["layers"]
    return {"w_in": ((n_features, h), n_features ** -0.5),
            "b_in": ((h,), n_features ** -0.5),
            "w_conv": ((layers, h, h), h ** -0.5),
            "w_out": ((h, n_classes), h ** -0.5),
            "b_out": ((n_classes,), h ** -0.5)}


def init_leaves(seed: int, config: dict, n_features: int, n_classes: int,
                device) -> dict:
    """The five leaves by name: one uniform draw in [-1, 1) on ``device``
    from ``seed``, each leaf's slice scaled by its bound."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    shapes = leaf_shapes(config, n_features, n_classes)
    flat = torch.empty(sum(math.prod(s) for s, _ in shapes.values()),
                       device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    out, at = {}, 0
    for name, (shape, bound) in shapes.items():
        k = math.prod(shape)
        out[name] = (flat[at:at + k] * bound).view(shape).clone()
        at += k
    return out


def pieces(leaves: dict) -> list:
    """The compared leaves in order: ``w_in``, ``b_in``, each layer's
    conv weight, ``w_out``, ``b_out``."""
    return [leaves["w_in"], leaves["b_in"], *leaves["w_conv"].unbind(0),
            leaves["w_out"], leaves["b_out"]]


def norms(leaves: dict) -> list[float]:
    return [float(t.double().norm()) for t in pieces(leaves)]


def readings(out: dict) -> dict:
    """The reference's readings in the form of tasks/gat.py::readings:
    each step's loss, each compared leaf's first-gradient and change
    norms, the first step's train-row logits."""
    return {"losses": [float(v) for v in out["losses"]],
            "grad1": norms(out["grad1"]), "change": norms(out["change"]),
            "logits": out["logits1"]}


def work_counts(csr, data, config: dict) -> dict:
    """One step's sizes, from the benchmark's own operator: its nodes,
    entries and used columns, and those of its transpose (the backward's
    products)."""
    return {"n": csr.shape[0], "nnz": int(csr.nnz),
            "used_cols": int(np.unique(csr.indices).size),
            "used_cols_t": int(np.count_nonzero(np.diff(csr.indptr))),
            "n_train": len(data.idx_train),
            "features": int(data.features.shape[1]),
            "classes": int(data.n_classes), "layers": config["layers"],
            "hidden": config["hidden"]}


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, process_start: float) -> RunRecord:
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models.gcnii import (GCNII, gcnii_apply,
                                            scaled_operator)
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.train.loops import node_cross_entropy, train_target

    from portbench import trace as tr
    from portbench.reference import gcnii as ref

    rec = RunRecord(config=config)
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    opt_cfg, wd = config["optimizer"], config["optimizer"]["weight_decay"]
    alpha, lamda = config["alpha"], config["lambda"]

    t0 = time.perf_counter()
    log(f"set-up starts at {t0 - process_start:.2f} s")
    data = graphgen.generate(config["shape"], traffic["graph"], seed)
    csr = graphgen.normalized(data)
    log(f"graph {data.n} nodes, {csr.nnz} entries: "
        f"{time.perf_counter() - t0:.2f} s")
    rec.counts = work_counts(csr, data, config)
    g = SparseGraph.from_scipy(csr).to(device)
    del csr
    kernels.load_all(device)
    log(f"kernels loaded at {time.perf_counter() - process_start:.2f} s")
    t0 = time.perf_counter()
    scaled = scaled_operator(g, alpha)
    del g
    log(f"operator and transpose {time.perf_counter() - t0:.2f} s")
    x = torch.as_tensor(data.features, device=device)
    target = train_target(scaled.n_rows, data.idx_train, torch.as_tensor(
        data.labels[data.idx_train], device=device))
    idx_train = torch.as_tensor(data.idx_train, device=device)
    init = init_leaves(seed, config, data.features.shape[1], data.n_classes,
                       device)
    model = GCNII(*(init[k].clone() for k in LEAVES))
    opt = torch.optim.Adam(
        [{"params": model.conv_params(), "weight_decay": wd["conv"]},
         {"params": model.dense_params(), "weight_decay": wd["dense"]}],
        lr=opt_cfg["lr"], betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"])
    log(f"model placed at {time.perf_counter() - process_start:.2f} s")
    losses = []

    def step(phase, keep=None):
        opt.zero_grad(set_to_none=True)
        with phase("forward"):
            logits = gcnii_apply(model, x, scaled, alpha, lamda)
            loss = node_cross_entropy(logits, *target)
        if keep is not None:
            keep["logits"] = logits.detach()[idx_train]
        del logits
        with phase("backward"):
            loss.backward()
        if keep is not None:
            keep["grad1"] = norms({k: getattr(model, k).grad
                                   for k in LEAVES})
        with phase("optimizer"):
            opt.step()
        losses.append(loss.detach())

    first = traffic["first_steps"]
    t0 = time.perf_counter()
    kept = {}
    for k in range(first):
        step(Phases(), kept if k == 0 else None)
    change = norms({k: getattr(model, k).detach() - init[k] for k in LEAVES})
    first_losses = [float(v) for v in losses]
    losses.clear()
    rec.setup_s = time.perf_counter() - process_start
    log(f"first steps {time.perf_counter() - t0:.2f} s, losses "
        f"{first_losses}; set-up {rec.setup_s:.2f} s")
    timed_loop(step, seconds, rec, device, events=trace)
    log(f"window {rec.window_s:.3f} s, {rec.steps} steps")
    if trace and device.type == "cuda":
        rec.trace = tr.profile_steps(step, traffic["trace_steps"],
                                     lambda: Phases(annotate=True))
    if device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    rec.failed = int((~torch.isfinite(torch.stack(losses[:rec.steps]))).sum())

    # the program's state goes before the reference runs
    del model, opt, scaled, x, target, losses, idx_train
    release_program(device)
    t0 = time.perf_counter()
    want = ref.train(init, data.src, data.dst, data.n, data.features,
                     data.labels, data.idx_train,
                     {"alpha": alpha, "lambda": lamda}, opt_cfg, first,
                     device)
    log(f"reference {time.perf_counter() - t0:.2f} s")
    got = {"losses": first_losses, "grad1": kept["grad1"], "change": change,
           "logits": kept.pop("logits")}
    limits = config["limits"]
    gaps = spec.task("gat").gaps(got, readings(want))
    rec.checks = [Check(k, v, limits[k]) for k, v in gaps.items()]
    return rec


def upper(config: dict, traffic: dict, seed: int, device) -> dict:
    """The upper readings of ``portbench.control_cells`` for this cell on
    one seed: the control (the reference in TF32) and each fault planted in
    the float64 reference (half of the train rows in the loss, the state
    left unchanged, one train row's first logits replaced by another's,
    the middle layer's ``alpha h0`` left out), each held against the
    float64 reference as a run holds the program."""
    from portbench.reference import gcnii as ref

    gat = spec.task("gat")
    first = traffic["first_steps"]
    d = graphgen.generate(config["shape"], traffic["graph"], seed)
    init = init_leaves(seed, config, d.features.shape[1], d.n_classes,
                       device)
    args = (init, d.src, d.dst, d.n, d.features, d.labels, d.idx_train,
            {"alpha": config["alpha"], "lambda": config["lambda"]},
            config["optimizer"], first, device)
    want = readings(ref.train(*args))
    out = {"control": gat.gaps(readings(ref.train(*args, "tf32")), want)}
    half = readings(ref.train(*args, half_batch=True))
    dropped = readings(ref.train(*args,
                                 drop_residual=config["layers"] // 2))
    still = {"losses": [want["losses"][0]] * first, "grad1": want["grad1"],
             "change": [0.0] * len(want["change"]),
             "logits": want["logits"]}
    moved = dict(want, logits=want["logits"].clone())
    moved["logits"][0] = want["logits"][1]
    out["faults"] = {"half_batch": gat.gaps(half, want),
                     "unchanged": gat.gaps(still, want),
                     "altered_logits": gat.gaps(moved, want),
                     "dropped_residual": gat.gaps(dropped, want)}
    return out
