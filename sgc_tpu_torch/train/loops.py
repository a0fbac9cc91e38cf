"""Full-batch head training and evaluation (the counterpart of
sgc_tpu/train/loops.py). Training never touches the graph: these loops
consume propagated features only.

* :func:`train_regression` — the citation trainer: ``torch.optim.Adam(lr,
  weight_decay)`` for ``epochs`` full-batch cross-entropy steps. The
  reference's ``torch_adam`` (train/optim.py) is a copy of this optimizer
  (L2 added to the gradient before the moments, betas 0.9/0.999, eps
  1e-8, on w and b), so the port runs the optimizer itself.
  :func:`train_regression_many` trains one head per weight decay at once
  (one param group each).
* :func:`train_linear` — the linear-head fit with manual L2 on W, by
  ``_newton_linear_fit`` (the accelerated Böhning/Newton fit,
  train/optim.py) or ``_lbfgs_linear_fit``, the oracle:
  ``torch.optim.LBFGS`` itself, with ``epochs`` ``.step()`` calls of
  ``max_iter=20`` iterations, ``lr`` and ``history_size=min(100, epochs *
  20)``, the settings the reference's ``lbfgs_fit_pytree`` reproduces
  (tests/test_lbfgs_torch_oracle.py pins that equivalence). Both minimize
  a (weighted) mean cross-entropy plus ``0.5 * wd * ||W||^2`` and return
  a new :class:`SGC` and that loss. :func:`eval_linear` scores a head.
* :func:`train_gcn` — the GCN trainer (the reference's ``train_gcn`` /
  ``_gcn_fit``): Adam on the cross-entropy of the train rows, the graph
  propagation inside every step, a fresh dropout mask each epoch.
* :func:`train_gcnii` — the GCNII trainer, as :func:`train_gcn` with the
  authors' two Adam parameter groups (L2 on the conv weights and on the
  dense layers apart).

Each trainer returns the seconds its work took on the device: a host
clock closed by a sync. The input model is never modified. Before the
timer, the Adam trainers take one warm step on a throwaway copy of the
model, so the one-time costs of a first step (the optimizer's state, the
first launches of its kernels) stay out of the timed span, as the
reference compiles its epoch loop before its timer; the returned model
is the same bits either way.
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch
import torch.nn.functional as F

from sgc_tpu_torch.models.gcn import GCN, gcn_apply
from sgc_tpu_torch.models.gcnii import GCNII, gcnii_apply, scaled_operator
from sgc_tpu_torch.models.sgc import SGC
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.autograd import transposed
from sgc_tpu_torch.train.metrics import hit_rate
from sgc_tpu_torch.train.optim import newton_linear_fit
from sgc_tpu_torch.utils.profiling import sync


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy; the weighted mean
    ``sum(w_i l_i) / sum(w_i)`` when class weights are given."""
    return F.cross_entropy(logits, labels.long(), weight=class_weights)


def binary_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean BCE on sigmoid(logits) vs {0, 1} labels."""
    logits = logits.squeeze()
    return F.binary_cross_entropy_with_logits(logits,
                                              labels.to(logits.dtype))


def _head_loss(model: SGC, features, labels, weight_decay, class_weights,
               binary: bool, weighted: bool) -> torch.Tensor:
    logits = model(features)
    l2 = 0.5 * weight_decay * (model.w ** 2).sum()
    if binary:
        if weighted:
            lg = logits.squeeze()
            ll = F.binary_cross_entropy_with_logits(
                lg, labels.to(lg.dtype), reduction="none")
            sw = class_weights[labels.long()]
            return (sw * ll).sum() / sw.sum() + l2
        return binary_cross_entropy(logits, labels) + l2
    return cross_entropy(logits, labels,
                         class_weights if weighted else None) + l2


def _lbfgs_linear_fit(model: SGC, train_features: torch.Tensor,
                      train_labels: torch.Tensor, weight_decay: float,
                      class_weights: torch.Tensor, epochs: int,
                      binary: bool, weighted: bool, lr: float):
    """LBFGS oracle fit. Returns ``(fitted SGC, loss at the fit)``; the
    input head is left as it was."""
    fit = SGC(model.w.detach().clone(),
              None if model.b is None else model.b.detach().clone())
    opt = torch.optim.LBFGS(list(fit.parameters()), lr=lr, max_iter=20,
                            history_size=min(100, epochs * 20))

    def closure():
        opt.zero_grad()
        loss = _head_loss(fit, train_features, train_labels, weight_decay,
                          class_weights, binary, weighted)
        loss.backward()
        return loss

    for _ in range(epochs):
        opt.step(closure)
    with torch.no_grad():
        loss = _head_loss(fit, train_features, train_labels, weight_decay,
                          class_weights, binary, weighted)
    return fit.requires_grad_(False), loss


def _newton_linear_fit(model: SGC, train_features: torch.Tensor,
                       train_labels: torch.Tensor, weight_decay: float,
                       class_weights: torch.Tensor, steps: int,
                       binary: bool, weighted: bool):
    """Böhning/Newton fit. Returns ``(fitted SGC, loss)``."""
    sw = class_weights[train_labels.long()] if weighted else None
    b0 = None if model.b is None else model.b.detach()
    w, b, loss = newton_linear_fit(
        model.w.detach(), b0, train_features, train_labels, weight_decay,
        sample_weights=sw, steps=steps, binary=binary)
    return SGC(w, b).requires_grad_(False), loss


def _trainable_copy(model: SGC) -> SGC:
    return SGC(model.w.detach().clone(),
               None if model.b is None else model.b.detach().clone())


def _adam_steps(groups, lr: float, loss_fn, epochs: int,
                losses=None) -> None:
    """``epochs`` Adam steps on ``loss_fn()`` over the param ``groups``;
    a vector loss is summed for the backward. The loss of epoch e (before
    its update) goes to ``losses[..., e]`` when given."""
    opt = torch.optim.Adam(groups, lr=lr)
    for e in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        (loss.sum() if loss.dim() else loss).backward()
        opt.step()
        if losses is not None:
            losses[..., e] = loss.detach()


def train_regression(model: SGC, train_features: torch.Tensor,
                     train_labels: torch.Tensor, epochs: int = 100,
                     weight_decay: float = 5e-6, lr: float = 0.2,
                     writer=None):
    """Adam full-batch logistic regression. Returns ``(fitted SGC,
    seconds)``.

    ``writer`` (utils.profiling.ScalarWriter) records the loss of every
    epoch, taken before that epoch's update, after the timed span.
    """
    y = train_labels.long()

    def run(fit, n_epochs, losses=None):
        _adam_steps([{"params": list(fit.parameters()),
                      "weight_decay": weight_decay}], lr,
                    lambda: cross_entropy(fit(train_features), y), n_epochs,
                    losses)

    # a warm step, thrown away: its loss record launches the copy too
    run(_trainable_copy(model), 1,
        torch.empty(1, device=train_features.device))
    fit = _trainable_copy(model)
    losses = torch.empty(epochs, device=train_features.device)
    t = perf_counter()
    run(fit, epochs, losses)
    sync(train_features.device)
    dt = perf_counter() - t
    if writer is not None:
        writer.scalars("train/loss", losses.tolist())
        writer.flush()
    return fit.requires_grad_(False), dt


def train_regression_many(model: SGC, train_features: torch.Tensor,
                          train_labels: torch.Tensor, weight_decays,
                          epochs: int = 100, lr: float = 0.2):
    """Train one head per weight decay at once, each from ``model``:
    one Adam param group per candidate (its own ``weight_decay``), the
    candidates' logits in one batched matmul. Candidate i follows the
    same updates as ``train_regression(..., weight_decay=wd[i])``.

    Returns ``(heads, losses, seconds)``: a list of SGC heads in the order
    of ``weight_decays`` and the float32 ``[n_candidates, epochs]`` losses.
    """
    wds = [float(w) for w in weight_decays]
    k, n = len(wds), int(train_features.shape[0])
    y_all = train_labels.long().repeat(k)

    def each_loss(heads):
        """The candidates' mean losses ``[k]``, their logits in one
        batched matmul."""
        logits = torch.matmul(train_features,
                              torch.stack([h.w for h in heads]))
        if model.b is not None:
            logits = logits + torch.stack([h.b for h in heads])[:, None, :]
        return F.cross_entropy(logits.reshape(k * n, -1), y_all,
                               reduction="none").view(k, n).mean(dim=1)

    def run(heads, n_epochs, losses=None):
        _adam_steps([{"params": list(h.parameters()), "weight_decay": wd}
                     for h, wd in zip(heads, wds)], lr,
                    lambda: each_loss(heads), n_epochs, losses)

    run([_trainable_copy(model) for _ in wds], 1,   # warm step, thrown away
        torch.empty((k, 1), device=train_features.device))
    heads = [_trainable_copy(model) for _ in wds]
    losses = torch.empty((k, epochs), device=train_features.device)
    t = perf_counter()
    run(heads, epochs, losses)
    sync(train_features.device)
    return ([h.requires_grad_(False) for h in heads], losses,
            perf_counter() - t)


def train_linear(model: SGC, train_features: torch.Tensor,
                 train_labels: torch.Tensor, weight_decay: float = 0.0,
                 epochs: int = 3, binary: bool = False,
                 class_weights: torch.Tensor | None = None, lr: float = 1.0,
                 trainer: str = "lbfgs", newton_steps: int = 8):
    """Linear-head fit with manual L2 on W. Returns ``(fitted SGC,
    seconds)``. ``trainer="lbfgs"`` is the oracle (``epochs``, ``lr``);
    ``"newton"`` runs ``newton_steps`` Böhning/Newton steps on the same
    loss."""
    if trainer not in ("lbfgs", "newton"):
        raise ValueError(f"unknown trainer {trainer!r}")
    weighted = class_weights is not None
    if not weighted:
        class_weights = torch.ones(model.w.shape[1],
                                   device=train_features.device)
    t = perf_counter()
    if trainer == "newton":
        fit, _ = _newton_linear_fit(model, train_features, train_labels,
                                    weight_decay, class_weights,
                                    newton_steps, binary, weighted)
    else:
        fit, _ = _lbfgs_linear_fit(model, train_features, train_labels,
                                   weight_decay, class_weights, epochs,
                                   binary, weighted, lr)
    sync(train_features.device)
    return fit, perf_counter() - t


def train_target(n_rows: int, train_idx, train_labels: torch.Tensor):
    """``(labels, weights)`` over all ``n_rows`` nodes for
    :func:`node_cross_entropy`: the train rows' labels in place and each
    row's weight its count in ``train_idx`` (0 elsewhere), built once,
    outside the gradient."""
    dev = train_labels.device
    idx = torch.as_tensor(np.asarray(train_idx), device=dev).long()
    labels = torch.zeros(n_rows, dtype=torch.long, device=dev)
    labels[idx] = train_labels.long()
    weights = torch.bincount(idx, minlength=n_rows).float()
    return labels, weights


def node_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of the train rows, ``sum(w_i l_i) /
    sum(w_i)`` over all rows (:func:`train_target`). Where the reference
    gathers ``logits[train_idx]``, this weights every row: the backward of
    a gather is an atomic scatter on CUDA, that of a product is not."""
    losses = F.cross_entropy(logits, labels, reduction="none")
    return (losses * weights).sum() / weights.sum()


def _gcn_copy(model: GCN) -> GCN:
    return GCN(*(p.detach().clone() for p in (model.w1, model.b1, model.w2,
                                               model.b2)))


def train_gcn(model: GCN, features: torch.Tensor, graph, train_idx,
              train_labels: torch.Tensor, epochs: int = 100,
              weight_decay: float = 5e-6, lr: float = 0.01,
              dropout: float = 0.5, seed: int = 42):
    """Full-batch GCN training (sgc_tpu/train/loops.py:291-348): Adam
    (``torch.optim.Adam(lr, weight_decay)``, the optimizer the
    reference's ``torch_adam`` copies) on the cross-entropy of the train
    rows, with a fresh dropout mask each epoch drawn from a
    ``torch.Generator`` on the features' device seeded with ``seed``.
    Returns ``(fitted GCN, seconds)``.

    Per epoch: two kernel-B SpMMs forward and two over the transpose
    backward. The kernel libraries, the transpose and one warm step on a
    throwaway copy are done before the timer, so the seconds span the
    epochs alone; the reference's timer also covers its first-call jit of
    the epoch loop (loops.py:313-320).
    """
    dev = features.device
    kernels.load_all(dev)
    transposed(graph)
    labels, weights = train_target(graph.n_rows, train_idx, train_labels)

    def run(fit, n_epochs):
        generator = torch.Generator(device=dev).manual_seed(seed)
        _adam_steps([{"params": list(fit.parameters()),
                      "weight_decay": weight_decay}], lr,
                    lambda: node_cross_entropy(
                        gcn_apply(fit, features, graph, dropout_rate=dropout,
                                  generator=generator), labels, weights),
                    n_epochs)

    run(_gcn_copy(model), 1)                # warm step, thrown away
    fit = _gcn_copy(model)
    t = perf_counter()
    run(fit, epochs)
    sync(dev)
    return fit.requires_grad_(False), perf_counter() - t


def _gcnii_copy(model: GCNII) -> GCNII:
    return GCNII(*(p.detach().clone() for p in (
        model.w_in, model.b_in, model.w_conv, model.w_out, model.b_out)))


def train_gcnii(model: GCNII, features: torch.Tensor, graph, train_idx,
                train_labels: torch.Tensor, epochs: int = 100,
                lr: float = 0.01, wd_conv: float = 0.01,
                wd_dense: float = 5e-4, alpha: float = 0.1,
                lamda: float = 0.5, dropout: float = 0.6, seed: int = 42):
    """Full-batch GCNII training (the authors' ``train.py`` step without
    its early stopping): ``torch.optim.Adam(lr)`` with two parameter
    groups, the conv weights at weight decay ``wd_conv`` and the dense
    layers at ``wd_dense``, on the cross-entropy of the train rows, with a
    fresh dropout mask each epoch drawn from a ``torch.Generator`` on the
    features' device seeded with ``seed``. ``graph`` is ``S``; the
    prescaled operator ``(1 - alpha) S`` is built here, once. Returns
    ``(fitted GCNII, seconds)``.

    Per epoch: one kernel-B launch a layer forward (the initial residual
    added in it) and one over the transpose backward. The kernel
    libraries, the operator, its transpose and one warm step on a
    throwaway copy are done before the timer, so the seconds span the
    epochs alone.
    """
    dev = features.device
    kernels.load_all(dev)
    scaled = scaled_operator(graph, alpha)
    labels, weights = train_target(graph.n_rows, train_idx, train_labels)

    def run(fit, n_epochs):
        generator = torch.Generator(device=dev).manual_seed(seed)
        _adam_steps([{"params": fit.conv_params(), "weight_decay": wd_conv},
                     {"params": fit.dense_params(),
                      "weight_decay": wd_dense}], lr,
                    lambda: node_cross_entropy(
                        gcnii_apply(fit, features, scaled, alpha, lamda,
                                    dropout, generator), labels, weights),
                    n_epochs)

    run(_gcnii_copy(model), 1)              # warm step, thrown away
    fit = _gcnii_copy(model)
    t = perf_counter()
    run(fit, epochs)
    sync(dev)
    return fit.requires_grad_(False), perf_counter() - t


@torch.no_grad()
def eval_linear(model: SGC, features: torch.Tensor, labels: torch.Tensor,
                binary: bool = False) -> dict:
    """Loss, accuracy and predictions of a head on one split."""
    logits = model(features)
    if binary:
        loss = binary_cross_entropy(logits, labels)
        preds = (torch.sigmoid(logits.squeeze()) > 0.5).to(labels.dtype)
    else:
        loss = cross_entropy(logits, labels)
        preds = logits.argmax(dim=1)
    return {"loss": float(loss), "accuracy": hit_rate(preds, labels),
            "predictions": preds}
