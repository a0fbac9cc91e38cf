"""The system under test for GAT configurations: full-batch training
steps in a closed loop.

Set-up builds one training object: the graph from the traffic's draw and
``--seed`` placed as a ``SparseGraph`` (its transpose cached by the
port's autograd), the features, the train rows' target
(``train/loops.py::train_target``), the two stacked-head layers from
weights drawn on the device from the seed, and ``torch.optim.Adam``. It
drives that object through the traffic's ``first_steps`` steps with the
window's own step function and keeps what the comparison needs: the
first step's logits of the train rows, each of those steps' loss, the
first gradient as Adam holds it (its first moment over ``1 - beta1``
after one step), and the parameters after the steps, before the next
step changes them. The window goes on with the same object.

A step: ``multi_head_gat`` twice (``models/gat.py``; ELU and concat,
then the heads' mean), ``node_cross_entropy``, ``backward()`` through
``ops/autograd.py`` (kernels B and D), ``Adam.step()``, closed by a
synchronize. Phases: ``forward``, ``backward``, ``optimizer``.

After the window the plain reference (reference/gat.py) follows the same
first steps in float64 from the same weights: ``loss_gap`` (the worst
step's loss gap over the reference's), ``grad_gap`` and ``change_gap``
(the worst leaf's gap of norms, over the larger of that leaf's and the
median leaf's reference norm; the change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's), and
``logit_gap`` (the first step's worst train-row logit gap, over the
reference's largest logit there).
"""

from __future__ import annotations

import math
import time

import torch

from portbench import graphgen
from portbench.record import (Check, Phases, RunRecord, log,
                              release_program, timed_loop)

SMALL_LEAF = 1e-3   # a leaf under this share of the median gradient


def init_layers(seed: int, layers: list, device) -> list[torch.Tensor]:
    """The eight leaves ``(w, a_src, a_dst, bias)`` of each layer
    ``{"heads", "f_in", "f_out"}``: one normal draw on ``device`` from
    ``seed``, Glorot-normal ``w``, N(0, 0.1^2) attention vectors, zero
    bias (the port's ``init_multi_head`` rule)."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    shapes = []
    for ly in layers:
        h, fi, fo = ly["heads"], ly["f_in"], ly["f_out"]
        shapes += [((h, fi, fo), math.sqrt(2.0 / (fi + fo))),
                   ((h, fo), 0.1), ((h, fo), 0.1), ((h, fo), 0.0)]
    flat = torch.randn(sum(math.prod(s) for s, _ in shapes), device=device,
                       generator=gen)
    out, at = [], 0
    for shape, std in shapes:
        k = math.prod(shape)
        out.append((flat[at:at + k] * std).view(shape).clone())
        at += k
    return out


def leaf_gap(prog: list[float], ref: list[float], keep=None) -> float:
    """The worst leaf's ``|prog - ref| / max(ref, median ref)``."""
    med = float(torch.tensor(ref).median())
    idx = range(len(ref)) if keep is None else keep
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in idx)


def readings(out: dict) -> dict:
    """Each first step's loss, each leaf's first-gradient norm and each
    leaf's change norm, as floats, from tensors; the first step's
    train-row logits as they are."""
    return {"losses": [float(v) for v in out["losses"]],
            "grad1": [float(t.norm()) for t in out["grad1"]],
            "change": [float(t.norm()) for t in out["change"]],
            "logits": out["logits1"]}


def gaps(got: dict, want: dict) -> dict:
    """``loss_gap``, ``grad_gap``, ``change_gap`` and ``logit_gap`` of
    readings ``got`` against the reference's ``want``; the change leaves
    out leaves whose reference gradient is under :data:`SMALL_LEAF` of
    the median leaf's."""
    med = float(torch.tensor(want["grad1"]).median())
    keep = [i for i, v in enumerate(want["grad1"]) if v >= SMALL_LEAF * med]
    ref_logits = want["logits"]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], want["losses"])),
            "grad_gap": leaf_gap(got["grad1"], want["grad1"]),
            "change_gap": leaf_gap(got["change"], want["change"], keep),
            "logit_gap": float((got["logits"].to(ref_logits) - ref_logits)
                               .abs().max() / ref_logits.abs().max())}


def work_counts(csr, data, config: dict) -> dict:
    ls = config["layers"]
    return {"n": csr.shape[0], "nnz": int(csr.nnz),
            "n_train": len(data.idx_train), "layers": ls}


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, process_start: float) -> RunRecord:
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models.gat import GATLayer, multi_head_gat
    from sgc_tpu_torch.ops import kernels
    from sgc_tpu_torch.ops.autograd import transposed
    from sgc_tpu_torch.train.loops import node_cross_entropy, train_target

    from portbench import trace as tr
    from portbench.reference import gat as ref

    rec = RunRecord(config=config)
    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    opt_cfg = config["optimizer"]

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
    transposed(g)
    log(f"transpose {time.perf_counter() - t0:.2f} s")
    x = torch.as_tensor(data.features, device=device)
    target = train_target(g.n_rows, data.idx_train, torch.as_tensor(
        data.labels[data.idx_train], device=device))
    idx_train = torch.as_tensor(data.idx_train, device=device)
    init = init_layers(seed, config["layers"], device)
    layers = [GATLayer(*(t.clone() for t in init[i:i + 4]))
              for i in (0, 4)]
    params = [p for m in layers for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=opt_cfg["lr"],
                           betas=tuple(opt_cfg["betas"]),
                           eps=opt_cfg["eps"],
                           weight_decay=opt_cfg["weight_decay"])
    log(f"model placed at {time.perf_counter() - process_start:.2f} s")
    losses = []

    def step(phase, keep=None):
        opt.zero_grad(set_to_none=True)
        with phase("forward"):
            h = multi_head_gat(layers[0], x, g)
            logits = multi_head_gat(layers[1], h, g, concat=False,
                                    activation=None)
            loss = node_cross_entropy(logits, *target)
        if keep is not None:
            keep["logits"] = logits.detach()[idx_train]
        with phase("backward"):
            loss.backward()
        with phase("optimizer"):
            opt.step()
        losses.append(loss.detach())

    first = traffic["first_steps"]
    beta1 = opt_cfg["betas"][0]
    t0 = time.perf_counter()
    kept = {}
    for k in range(first):
        step(Phases(), kept if k == 0 else None)
        if k == 0:
            grad1 = [float((opt.state[p]["exp_avg"] / (1 - beta1)).norm())
                     for p in params]
    change = [float((p.detach() - t).norm()) for p, t in zip(params, init)]
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
    del layers, params, opt, g, x, target, losses, idx_train
    release_program(device)
    t0 = time.perf_counter()
    want = ref.train(init, data.src, data.dst, data.n, data.features,
                     data.labels, data.idx_train, opt_cfg, first, device)
    log(f"reference {time.perf_counter() - t0:.2f} s")
    got = {"losses": first_losses, "grad1": grad1, "change": change,
           "logits": kept.pop("logits")}
    limits = config["limits"]
    rec.checks = [Check(k, v, limits[k])
                  for k, v in gaps(got, readings(want)).items()]
    return rec
