"""The accelerated Böhning/Newton head fit (the counterpart of
``newton_linear_fit`` in sgc_tpu/train/optim.py).

Dense linear algebra only (matmuls and one Cholesky factor), which the
reference leaves to XLA and the port leaves to PyTorch. The reference's
jittable LBFGS has no counterpart here: the port's LBFGS oracle is
``torch.optim.LBFGS`` itself (train/loops.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.no_grad()
def newton_linear_fit(
    w0: torch.Tensor,                       # [F, C] (C = 1 for binary)
    b0: torch.Tensor | None,                # [C] or None
    features: torch.Tensor,                 # [n, F]
    labels: torch.Tensor,                   # int [n] (binary: {0, 1})
    weight_decay: float,
    sample_weights: torch.Tensor | None = None,   # [n]
    steps: int = 8,
    binary: bool = False,
):
    """Fit a linear softmax (or sigmoid) head by majorize-minimize Newton
    steps under the fixed Böhning curvature bound ``H <= c * Z'Z/n + wd I``
    (c = 1/2 softmax, 1/4 sigmoid), with Nesterov momentum and an exact
    line search over an 8-point step grid evaluated as one batch.

    Returns ``(w, b, loss)``; ``b`` is None iff ``b0`` is None. The loss
    includes ``0.5 * wd * ||W||^2``.
    """
    n = features.shape[0]
    C = w0.shape[1]
    has_bias = b0 is not None
    f32 = torch.float32
    dev = features.device

    if has_bias:
        Z = torch.cat([features, torch.ones((n, 1), dtype=f32, device=dev)],
                      dim=1)
        theta0 = torch.cat([w0, b0[None, :]], dim=0)
    else:
        Z = features
        theta0 = w0
    d = Z.shape[1]

    sw = (torch.ones((n,), dtype=f32, device=dev) if sample_weights is None
          else sample_weights.to(f32))
    sw_sum = sw.sum()
    curv = 0.25 if binary else 0.5
    A = (Z.T @ (Z * sw[:, None])) / sw_sum
    # wd penalizes W only; the bias keeps a small ridge so the factor
    # stays positive definite when wd == 0
    ridge = 1e-6 * torch.trace(A) / d
    diag = torch.full((d,), float(ridge), dtype=f32, device=dev) + weight_decay
    if has_bias:
        diag[-1] = ridge
    factor = torch.linalg.cholesky(curv * A + torch.diag(diag))

    y_idx = labels.long()
    y = (y_idx.to(f32)[:, None] if binary
         else F.one_hot(y_idx, C).to(f32))                 # [n, C]

    def w_of(theta):
        return theta[..., :-1, :] if has_bias else theta

    def batched_loss(logits, w):
        """Losses of a batch of iterates: logits [T, n, C], w [T, F, C]."""
        l2 = 0.5 * weight_decay * (w ** 2).sum(dim=(1, 2))
        if binary:
            ll = F.logsigmoid(logits) * y + F.logsigmoid(-logits) * (1.0 - y)
            return -(sw[None, :, None] * ll).sum(dim=(1, 2)) / sw_sum + l2
        lp = torch.log_softmax(logits, dim=-1)
        picked = lp.gather(
            -1, y_idx[None, :, None].expand(lp.shape[0], n, 1))[..., 0]
        return -(sw[None] * picked).sum(dim=1) / sw_sum + l2

    def probs(logits):
        return torch.sigmoid(logits) if binary else torch.softmax(logits, -1)

    # t = 0 keeps the momentum point; large t exploits the bound's slack
    ts = torch.tensor([0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0], dtype=f32,
                      device=dev)
    theta, theta_prev = theta0, theta0
    loss = None
    for k in range(1, steps + 1):
        mom = (k - 1.0) / (k + 2.0)
        v = theta + mom * (theta - theta_prev)
        logits = Z @ v
        G = Z.T @ ((probs(logits) - y) * sw[:, None]) / sw_sum
        if has_bias:
            G = torch.cat([G[:-1] + weight_decay * w_of(v), G[-1:]], dim=0)
        else:
            G = G + weight_decay * v
        D = torch.cholesky_solve(G, factor)
        ZD = Z @ D
        tb = ts[:, None, None]
        losses = batched_loss(logits[None] - tb * ZD[None],
                              w_of(v)[None] - tb * w_of(D)[None])
        best = torch.argmin(losses)
        theta, theta_prev = v - ts[best] * D, theta
        loss = losses[best]
    w = w_of(theta)
    b = theta[-1] if has_bias else None
    return w, b, loss
