"""Plain reference of an SGC fit (Wu et al., ICML 2019): ``S^K X`` with
``S = D^-1/2 (A + I) D^-1/2``, then a linear softmax head fitted by
accelerated Böhning/Newton steps.

Plain PyTorch, in float64 by default. It builds the operator again from
the raw edge draws, so it shares nothing with the program but the
generated inputs. ``precision="tf32"`` is the control: every product's
operands rounded to TF32 (10 mantissa bits), as the tensor cores take
them, and summed in float32.

The head follows the published recipe (Böhning 1992's bound ``H <= Z'Z
/ 2n + wd I`` on the softmax loss, Nesterov momentum, and an exact line
search over the step grid ``0, 1/4, ..., 16``) from the configuration's
constants: ``steps``, ``weight_decay``, a bias with a ridge of ``1e-6
trace(A) / d`` so the factor stays positive definite at ``wd = 0``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

STEP_GRID = (0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
DTYPES = {"f64": torch.float64, "tf32": torch.float32}


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (ties away from
    zero, as the tensor cores' conversion): 13 low mantissa bits
    cleared."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class Arith:
    """The dtype and operand rounding of one precision."""

    def __init__(self, precision: str):
        if precision not in DTYPES:
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = DTYPES[precision]
        self.round = tf32 if precision == "tf32" else (lambda t: t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def spmm(self, s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``s @ x`` for a sparse CSR ``s`` whose values are rounded
        already."""
        return torch.sparse.mm(s, self.round(x))


def operator(src: np.ndarray, dst: np.ndarray, n: int, device,
             ar: Arith) -> torch.Tensor:
    """``S`` as a sparse CSR tensor of ``ar``'s dtype on ``device``: the
    draws' count matrix plus its transpose plus the identity, scaled by
    the inverse square roots of the row sums."""
    s = torch.as_tensor(np.asarray(src, np.int64), device=device)
    d = torch.as_tensor(np.asarray(dst, np.int64), device=device)
    loops = torch.arange(n, device=device)
    rows = torch.cat([s, d, loops])
    cols = torch.cat([d, s, loops])
    ones = torch.ones(rows.numel(), dtype=torch.float64, device=device)
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), ones, (n, n),
                                check_invariants=True).coalesce()
    r, c = a.indices()
    deg = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
        0, r, a.values())
    inv = deg.rsqrt()
    vals = (a.values() * inv[r] * inv[c]).to(ar.dtype)
    if ar.dtype == torch.float32:
        vals = ar.round(vals)
    with warnings.catch_warnings():     # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(a.indices(), vals, (n, n),
                                       check_invariants=True).to_sparse_csr()


def propagate(src, dst, n: int, features: np.ndarray, idx_train,
              degree: int, device, precision: str = "f64") -> torch.Tensor:
    """``(S^degree X)[idx_train]`` in ``precision``."""
    ar = Arith(precision)
    s = operator(src, dst, n, device, ar)
    x = torch.as_tensor(features, device=device).to(ar.dtype)
    for _ in range(degree):
        x = ar.spmm(s, x)
    idx = torch.as_tensor(np.asarray(idx_train, np.int64), device=device)
    return x[idx]


def _design(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones((p.shape[0], 1), dtype=p.dtype,
                                    device=p.device)], dim=1)


def head_loss(p: torch.Tensor, labels: torch.Tensor, theta: torch.Tensor,
              weight_decay: float) -> torch.Tensor:
    """Mean softmax cross-entropy of ``[p, 1] @ theta`` plus ``0.5 wd
    ||W||^2`` (the bias row is not penalized)."""
    logits = _design(p) @ theta.to(p.dtype)
    ce = torch.nn.functional.cross_entropy(logits, labels.long())
    return ce + 0.5 * weight_decay * (theta[:-1].to(p.dtype) ** 2).sum()


def newton_head(p: torch.Tensor, labels: torch.Tensor, theta0: torch.Tensor,
                weight_decay: float, steps: int, precision: str = "f64",
                margins: list | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(theta, loss)``: ``steps`` Böhning/Newton steps from ``theta0``
    (``[F + 1, C]``, the bias last) on the rows ``p`` (``[n, F]``).
    ``margins``, when given, gets each step's gap between its best and
    second-best grid loss over the best: how near the line search came
    to choosing another step."""
    ar = Arith(precision)
    z = _design(p.to(ar.dtype))
    n, d = z.shape
    theta0 = theta0.to(ar.dtype)
    c = theta0.shape[1]
    a = ar.mm(z.T, z) / n
    ridge = 1e-6 * torch.trace(a) / d
    diag = torch.full((d,), float(ridge), dtype=ar.dtype, device=z.device)
    diag[:-1] += weight_decay
    factor = torch.linalg.cholesky(0.5 * a + torch.diag(diag))
    y = torch.nn.functional.one_hot(labels.long(), c).to(ar.dtype)
    ts = torch.tensor(STEP_GRID, dtype=ar.dtype, device=z.device)

    theta, prev, loss = theta0, theta0, None
    for k in range(1, steps + 1):
        v = theta + (k - 1.0) / (k + 2.0) * (theta - prev)
        logits = ar.mm(z, v)
        g = ar.mm(z.T, torch.softmax(logits, dim=-1) - y) / n
        g[:-1] += weight_decay * v[:-1]
        step = torch.cholesky_solve(g, factor)
        zd = ar.mm(z, step)
        cand = logits[None] - ts[:, None, None] * zd[None]
        lp = torch.log_softmax(cand, dim=-1)
        ce = -lp.gather(-1, labels.long()[None, :, None].expand(
            len(ts), n, 1))[..., 0].mean(dim=1)
        w = v[None, :-1] - ts[:, None, None] * step[None, :-1]
        losses = ce + 0.5 * weight_decay * (w ** 2).sum(dim=(1, 2))
        best = int(torch.argmin(losses))
        if margins is not None:
            low = torch.sort(losses).values
            margins.append(float((low[1] - low[0]) / low[0].abs()))
        theta, prev = v - ts[best] * step, theta
        loss = losses[best]
    return theta, loss
