"""Plain PyTorch reference of GCNII (Chen et al., ICML 2020, "Simple and
Deep Graph Convolutional Networks") for the port's CPU tests.

The paper's equations in the authors' two-term form:

    h0  = relu(x W_in + b_in)
    s_l = (1 - alpha) S h_{l-1} + alpha h0
    h_l = relu((1 - beta_l) s_l + beta_l s_l W_l),  beta_l = ln(lamda / l + 1)
    out = h_L W_out + b_out

with ``S = D^-1/2 (A + I) D^-1/2`` rebuilt here from the raw edge draws
(``A = B + B^T``, ``B`` the draws' count matrix), and Adam with coupled
L2 (the decay added to the gradient before the moments, as
``torch.optim.Adam(weight_decay=)`` applies it): ``wd_conv`` on the conv
weights, ``wd_dense`` on the dense layers. It imports no kernel of the
port and no JAX, and runs with TF32 off.

``drop_residual`` (a layer, from 1) and ``beta_shift`` plant faults: that
layer's ``alpha h0`` left out, every ``beta_l`` taken at ``l +
beta_shift``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LEAVES = ("w_in", "b_in", "w_conv", "w_out", "b_out")


def operator(src, dst, n: int, dtype=torch.float64):
    """``(S, S^T)`` as sparse CSR tensors of ``dtype`` on the CPU."""
    s = torch.as_tensor(np.asarray(src, np.int64))
    d = torch.as_tensor(np.asarray(dst, np.int64))
    loops = torch.arange(n)
    rows, cols = torch.cat([s, d, loops]), torch.cat([d, s, loops])
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                torch.ones(len(rows), dtype=torch.float64),
                                (n, n), check_invariants=True).coalesce()
    r, c = a.indices()
    deg = torch.zeros(n, dtype=torch.float64).index_add_(0, r, a.values())
    vals = (a.values() * deg.rsqrt()[r] * deg.rsqrt()[c]).to(dtype)
    with warnings.catch_warnings():     # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return tuple(torch.sparse_coo_tensor(
            torch.stack(ix), vals, (n, n), check_invariants=True)
            .coalesce().to_sparse_csr() for ix in ((r, c), (c, r)))


class _Prop(torch.autograd.Function):
    """``S @ h``, its gradient ``S^T @ g``."""

    @staticmethod
    def forward(ctx, s, st, h):
        ctx.st = st
        return torch.sparse.mm(s, h)

    @staticmethod
    def backward(ctx, g):
        return None, None, torch.sparse.mm(ctx.st, g)


def forward(params: dict, x, ops, alpha: float, lamda: float,
            drop_residual: int | None = None, beta_shift: int = 0):
    """Logits ``[n, C]``; ``ops`` = :func:`operator`'s pair."""
    h0 = torch.relu(x @ params["w_in"] + params["b_in"])
    h = h0
    for i in range(params["w_conv"].shape[0]):
        layer = i + 1
        s = (1 - alpha) * _Prop.apply(*ops, h)
        if layer != drop_residual:
            s = s + alpha * h0
        beta = math.log(lamda / (layer + beta_shift) + 1)
        h = torch.relu((1 - beta) * s + beta * (s @ params["w_conv"][i]))
    return h @ params["w_out"] + params["b_out"]


def train(init: dict, x, src, dst, n: int, idx_train, labels, alpha: float,
          lamda: float, lr: float, wd_conv: float, wd_dense: float,
          steps: int, dtype=torch.float64, **faults) -> dict:
    """``steps`` full-batch Adam steps (betas 0.9 / 0.999, eps 1e-8) on
    the train rows' mean cross-entropy from ``init`` (the five leaves by
    name); ``labels`` covers every node. Returns ``losses`` (each
    step's, before its update), ``logits1`` (the first step's, every
    row), ``grad1`` (the first gradient, by leaf) and ``params`` (after
    the steps, by leaf)."""
    ops = operator(src, dst, n, dtype)
    x = torch.as_tensor(x).to(dtype)
    idx = torch.as_tensor(np.asarray(idx_train, np.int64))
    y = torch.as_tensor(np.asarray(labels)[np.asarray(idx_train)]).long()
    params = {k: torch.as_tensor(init[k]).detach().to(dtype).clone()
              .requires_grad_() for k in LEAVES}
    decay = {k: wd_conv if k == "w_conv" else wd_dense for k in LEAVES}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, out = [], {}
    for k in range(1, steps + 1):
        logits = forward(params, x, ops, alpha, lamda, **faults)
        loss = F.cross_entropy(logits[idx], y)
        grads = dict(zip(LEAVES, torch.autograd.grad(
            loss, [params[name] for name in LEAVES])))
        losses.append(float(loss.detach()))
        if k == 1:
            out["logits1"] = logits.detach()
            out["grad1"] = {name: g.detach() for name, g in grads.items()}
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name] + decay[name] * p
                m[name].mul_(b1).add_(g, alpha=1 - b1)
                v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** k, 1 - b2 ** k
                p.sub_(lr / c1 * m[name] / (v[name].sqrt() / c2 ** 0.5
                                            + eps))
    out["losses"] = losses
    out["params"] = {name: p.detach() for name, p in params.items()}
    return out
