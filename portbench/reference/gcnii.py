"""Plain reference of full-batch GCNII training (Chen et al., ICML 2020,
"Simple and Deep Graph Convolutional Networks"), in the authors' two-term
form:

    h0  = relu(x W_in + b_in)
    s_l = (1 - alpha) S h_{l-1} + alpha h0                 initial residual
    h_l = relu((1 - beta_l) s_l + beta_l s_l W_l),  beta_l = ln(lamda / l + 1)
    out = h_L W_out + b_out

then the train rows' mean cross-entropy and Adam with coupled L2 (the
decay added to the gradient before the moments): ``weight_decay.conv``
on the conv weights, ``weight_decay.dense`` on the two dense layers.

``S`` is ``reference/sgc.py::operator``, rebuilt from the raw edge draws,
and its transpose is built from it. Plain PyTorch in float64 by default;
blocks of :data:`BLOCK` layers run under activation checkpointing so that
one block's activations are held at a time. ``precision="tf32"`` is the
control: float32 with every product's operands rounded to TF32 (a
straight-through rounding; the backward's sparse products round theirs
too). ``drop_residual`` (a layer, from 1) plants a fault: that layer's
``alpha h0`` left out.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.gat import Arith
from portbench.reference.sgc import Arith as SgcArith
from portbench.reference.sgc import operator

LEAVES = ("w_in", "b_in", "w_conv", "w_out", "b_out")
BLOCK = 8       # layers a checkpointed block holds


def transpose(s: torch.Tensor) -> torch.Tensor:
    """The transpose of a sparse CSR tensor, as sparse CSR."""
    coo = s.to_sparse_coo()
    with warnings.catch_warnings():     # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            coo.indices().flip(0), coo.values(), coo.shape,
            check_invariants=True).coalesce().to_sparse_csr()


class _Prop(torch.autograd.Function):
    """``S @ h`` with ``h`` (and, in the backward, ``g``) rounded by
    ``ar``; the gradient ``S^T @ g``."""

    @staticmethod
    def forward(ctx, s, st, h, ar):
        ctx.st, ctx.ar = st, ar
        return torch.sparse.mm(s, ar.r(h))

    @staticmethod
    def backward(ctx, g):
        return None, None, torch.sparse.mm(ctx.st, ctx.ar.r(g)), None


def _block(h, h0, w_block, first: int, s, st, alpha: float, lamda: float,
           ar: Arith, drop_residual):
    """Layers ``first .. first + len(w_block) - 1`` (from 1)."""
    for i in range(w_block.shape[0]):
        layer = first + i
        out = (1 - alpha) * _Prop.apply(s, st, h, ar)
        if layer != drop_residual:
            out = out + alpha * h0
        beta = math.log(lamda / layer + 1)
        h = torch.relu((1 - beta) * out
                       + beta * (ar.r(out) @ ar.r(w_block[i])))
    return h


def forward(params: dict, x, s, st, alpha: float, lamda: float, ar: Arith,
            drop_residual=None) -> torch.Tensor:
    """Logits ``[n, C]``."""
    h0 = torch.relu(ar.r(x) @ ar.r(params["w_in"]) + params["b_in"])
    h = h0
    w = params["w_conv"]
    for first in range(0, w.shape[0], BLOCK):
        h = checkpoint(_block, h, h0, w[first:first + BLOCK], first + 1, s,
                       st, alpha, lamda, ar, drop_residual,
                       use_reentrant=False)
    return ar.r(h) @ ar.r(params["w_out"]) + params["b_out"]


def train(init: dict, src, dst, n: int, features: np.ndarray,
          labels: np.ndarray, idx_train: np.ndarray, model: dict,
          optimizer: dict, steps: int, device, precision: str = "f64",
          half_batch: bool = False, drop_residual=None) -> dict:
    """``steps`` full-batch Adam steps (``optimizer``: ``lr``, ``betas``,
    ``eps``, ``weight_decay`` ``{"conv", "dense"}``) from ``init`` (the
    five leaves by name) at ``model``'s ``alpha`` and ``lambda``.

    Returns ``losses`` (each step's loss, before its update),
    ``logits1`` (the first step's logits of every train row), ``grad1``
    and ``change`` (each leaf's first gradient and its change after the
    steps, by name), as tensors of ``precision``'s dtype. ``half_batch``
    is a fault: the loss of every other train row only.
    """
    ar = Arith(precision)
    s = operator(src, dst, n, device, SgcArith(precision))
    st = transpose(s)
    x = torch.as_tensor(features, device=device).to(ar.dtype)
    idx = torch.as_tensor(np.asarray(idx_train, np.int64), device=device)
    y = torch.as_tensor(np.asarray(labels)[np.asarray(idx_train)],
                        device=device).long()
    idx_all = idx
    if half_batch:
        idx, y = idx[::2], y[::2]
    params = {k: torch.as_tensor(init[k]).detach().to(device, ar.dtype)
              .clone().requires_grad_() for k in LEAVES}
    start = {k: p.detach().clone() for k, p in params.items()}
    wd = optimizer["weight_decay"]
    decay = {k: wd["conv"] if k == "w_conv" else wd["dense"]
             for k in LEAVES}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    lr, (b1, b2) = optimizer["lr"], optimizer["betas"]
    eps = optimizer["eps"]
    alpha, lamda = model["alpha"], model["lambda"]
    losses, out = [], {}
    for k in range(1, steps + 1):
        logits = forward(params, x, s, st, alpha, lamda, ar, drop_residual)
        loss = F.cross_entropy(logits[idx], y)
        grads = dict(zip(LEAVES, torch.autograd.grad(
            loss, [params[name] for name in LEAVES])))
        losses.append(loss.detach())
        if k == 1:
            out["logits1"] = logits.detach()[idx_all]
            out["grad1"] = {name: g.detach().clone()
                            for name, g in grads.items()}
        del logits
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name] + decay[name] * p
                m[name].mul_(b1).add_(g, alpha=1 - b1)
                v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** k, 1 - b2 ** k
                p.sub_(lr / c1 * m[name] / (v[name].sqrt() / c2 ** 0.5
                                            + eps))
    out["losses"] = torch.stack(losses)
    out["change"] = {k: params[k].detach() - start[k] for k in LEAVES}
    return out

