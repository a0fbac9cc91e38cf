"""Full-batch linear-head fits (the counterpart of the head trainers in
sgc_tpu/train/loops.py).

* ``_newton_linear_fit`` — the accelerated Böhning/Newton fit
  (train/optim.py), the main path's trainer.
* ``_lbfgs_linear_fit`` — the oracle: ``torch.optim.LBFGS`` itself, with
  ``epochs`` ``.step()`` calls of ``max_iter=20`` iterations, ``lr`` and
  ``history_size=min(100, epochs * 20)``, the settings the reference's
  ``lbfgs_fit_pytree`` reproduces (tests/test_lbfgs_torch_oracle.py pins
  that equivalence).

Both minimize the same loss: a (weighted) mean cross-entropy plus
``0.5 * wd * ||W||^2``, and both return a new :class:`SGC` and that loss.
The citation path's Adam trainers wait for a later slice of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgc_tpu_torch.models.sgc import SGC
from sgc_tpu_torch.train.optim import newton_linear_fit


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
