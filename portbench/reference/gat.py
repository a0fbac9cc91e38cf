"""Plain reference of full-batch GAT training (Veličković et al., ICLR
2018): two multi-head attention layers over the graph's pattern, the
train rows' mean cross-entropy, and Adam.

    e_vu  = LeakyReLU_0.2(a_dst . h_v + a_src . h_u),  h = x W
    alpha = softmax of e over the edges into v
    out_v = sum_u alpha_vu h_u + bias

Layer 1 concatenates its heads after an ELU; layer 2 averages its heads.
The pattern is ``A + A^T + I`` of the raw edge draws, built again here.
Plain PyTorch in float64 by default; each head runs under activation
checkpointing so that the edge-wide tensors of one head at a time are
held. ``precision="tf32"`` is the control: float32 with every product's
operands rounded to TF32 (a straight-through rounding, so the backward
takes the rounded operands too).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.sgc import DTYPES, tf32


def pattern(src, dst, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, cols)`` int64 of the distinct entries of ``A + A^T + I``."""
    s = torch.as_tensor(np.asarray(src, np.int64), device=device)
    d = torch.as_tensor(np.asarray(dst, np.int64), device=device)
    loops = torch.arange(n, device=device)
    key = torch.unique(torch.cat([s * n + d, d * n + s, loops * n + loops]))
    return key // n, key % n


class Arith:
    def __init__(self, precision: str):
        self.dtype = DTYPES[precision]
        self.tf32 = precision == "tf32"

    def r(self, t: torch.Tensor) -> torch.Tensor:
        if not self.tf32:
            return t
        return t + (tf32(t.detach()) - t).detach()


def _head(h, a_src, a_dst, bias, rows, cols, n: int, ar: Arith):
    """One head's attention output ``[n, F_out]`` on ``h = x W``."""
    s_dst = ar.r(h) @ ar.r(a_dst)
    s_src = ar.r(h) @ ar.r(a_src)
    e = F.leaky_relu(s_dst[rows] + s_src[cols], 0.2)
    top = torch.full((n,), -torch.inf, dtype=e.dtype, device=e.device)
    top = top.scatter_reduce(0, rows, e.detach(), "amax")
    ex = torch.exp(e - top[rows])
    den = torch.zeros(n, dtype=e.dtype, device=e.device).index_add(
        0, rows, ex)
    alpha = ex / den[rows]
    msg = ar.r(alpha)[:, None] * ar.r(h)[cols]
    out = torch.zeros((n, h.shape[1]), dtype=h.dtype,
                      device=h.device).index_add(0, rows, msg)
    return out + bias


def layer(x, w, a_src, a_dst, bias, rows, cols, n: int, concat: bool,
          ar: Arith):
    """A multi-head layer: ``w [H, F_in, F_out]``, ``a_* [H, F_out]``,
    ``bias [H, F_out]``; ELU and concatenation, or the heads' mean."""
    outs = []
    for i in range(w.shape[0]):
        h = ar.r(x) @ ar.r(w[i])
        o = checkpoint(_head, h, a_src[i], a_dst[i], bias[i], rows, cols,
                       n, ar, use_reentrant=False)
        outs.append(F.elu(o) if concat else o)
    return torch.cat(outs, dim=1) if concat else torch.stack(outs).mean(0)


def loss_of(params, x, rows, cols, n, idx_train, labels, ar: Arith):
    """The train rows' mean cross-entropy of the two-layer model, and its
    logits ``[n, C]``; ``params`` = (w1, a_src1, a_dst1, bias1, w2, a_src2,
    a_dst2, bias2)."""
    h = layer(x, *params[:4], rows, cols, n, True, ar)
    logits = layer(h, *params[4:], rows, cols, n, False, ar)
    return F.cross_entropy(logits[idx_train], labels), logits


def train(init, src, dst, n: int, features: np.ndarray, labels: np.ndarray,
          idx_train: np.ndarray, optimizer: dict, steps: int, device,
          precision: str = "f64", half_batch: bool = False) -> dict:
    """``steps`` full-batch Adam steps (Kingma & Ba 2015; ``optimizer``:
    ``lr``, ``betas``, ``eps``, and ``weight_decay`` added to the gradient
    as L2) from ``init`` (the eight leaves).

    Returns ``losses`` (each step's loss, before its update), ``logits1``
    (the first step's logits of every train row), ``grad1`` (each leaf's
    first gradient) and ``change`` (each leaf's change after the steps),
    as tensors of ``precision``'s dtype. ``half_batch`` is a fault: the
    loss of every other train row only.
    """
    ar = Arith(precision)
    rows, cols = pattern(src, dst, n, device)
    x = torch.as_tensor(features, device=device).to(ar.dtype)
    idx = torch.as_tensor(np.asarray(idx_train, np.int64), device=device)
    y = torch.as_tensor(np.asarray(labels)[np.asarray(idx_train)],
                        device=device).long()
    idx_all = idx
    if half_batch:
        idx, y = idx[::2], y[::2]
    params = [t.detach().to(device, ar.dtype).clone().requires_grad_()
              for t in init]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    lr, (b1, b2) = optimizer["lr"], optimizer["betas"]
    eps, wd = optimizer["eps"], optimizer["weight_decay"]
    losses, grad1 = [], None
    for k in range(1, steps + 1):
        loss, logits = loss_of(params, x, rows, cols, n, idx, y, ar)
        grads = torch.autograd.grad(loss, params)
        losses.append(loss.detach())
        if k == 1:
            grad1 = [g.detach().clone() for g in grads]
            logits1 = logits.detach()[idx_all]
        del logits
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                g = g + wd * p
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** k, 1 - b2 ** k
                p.sub_(lr / c1 * mi / (vi.sqrt() / c2 ** 0.5 + eps))
    change = [p.detach() - s for p, s in zip(params, start)]
    return {"losses": torch.stack(losses), "logits1": logits1,
            "grad1": grad1, "change": change}
