"""The head's cost on the card: a Böhning/Newton fit against the LBFGS
oracle (the counterpart of scripts/exp_newton_head.py).

From the bench's synthetic (the clustered Reddit-shaped graph at
``scale``, shuffled), the block-dense plan at the committed admission
(``calibrate=False``; on the card kernels A + B, the reference's
``formulation="blockdense"`` form being its TPU einsum) gives
``propagate_train(degree=2)``. Then, as the reference:

1. the LBFGS oracle (``train/loops.py::_lbfgs_linear_fit``,
   ``torch.optim.LBFGS``) for 2 epochs (40 iterations) at weight decay 0
   from ``init_sgc``'s head at seed 42: its loss and train accuracy;
2. the script's own Böhning majorize-minimize step: one Cholesky factor
   of ``(Z'Z/n)/2 + ridge`` (``Z = [X, 1]``, ridge ``1e-6 tr/(F+1)``),
   then per iteration one ``cholesky_solve`` and a five-point line search
   over t in {0.5, 1, 1.5, 2, 3}, from a zero head, until its loss and
   accuracy reach the oracle's (parity), at most 20 iterations.

Beside the reference's lines it times, warm and closed by a sync: the
oracle again, the factor, one Böhning iteration, the Böhning fit to
parity, and the package's own head, the bench's 8-step Newton fit
(``train/loops.py::_newton_linear_fit``), at the same weight decay.

    python -m sgc_tpu_torch.scripts.exp_newton_head [scale]
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import torch
import torch.nn.functional as F

from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
from sgc_tpu_torch.graph.locality import LocalityPlan
from sgc_tpu_torch.models.sgc import init_sgc, sgc_apply
from sgc_tpu_torch.scripts import backend, best_seconds, device_parser
from sgc_tpu_torch.train.loops import _lbfgs_linear_fit, _newton_linear_fit
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync

LBFGS_EPOCHS = 2
MAX_ITER = 20
LINE_SEARCH = (0.5, 1.0, 1.5, 2.0, 3.0)
PACKAGE_NEWTON_STEPS = 8
REPS = 3


def propagated(scale: float, device):
    """``((S^2 X)[idx_train], the train labels, the plan)`` on
    ``device``."""
    graph, features, labels, idx_train = synthetic_reddit_clustered(
        scale, shuffle=True)
    plan = LocalityPlan.build(graph, features, labels, idx_train,
                              formulation="auto", calibrate=False,
                              device=device)
    tr = plan.propagate_train(degree=2)
    y = torch.as_tensor(plan.labels[plan.idx_train], device=tr.device)
    return tr, y, plan


def accuracy(logits: torch.Tensor, y: torch.Tensor) -> float:
    return float((logits.argmax(dim=1) == y).float().mean())


def lbfgs(tr, y, params0, weight_decay: float = 0.0):
    """The oracle: ``(fitted head, loss, train accuracy)``."""
    C = int(params0.w.shape[1])
    fit, loss = _lbfgs_linear_fit(
        params0, tr, y.long(), weight_decay,
        torch.ones(C, device=tr.device), LBFGS_EPOCHS, False, False, 1.0)
    return fit, float(loss), accuracy(sgc_apply(fit, tr), y)


class Boehning:
    """The script's Böhning step on ``Z = [tr, 1]``, its factor built
    once (:meth:`step` from ``theta`` to ``(theta', loss at theta')``)."""

    def __init__(self, tr: torch.Tensor, y: torch.Tensor, n_classes: int):
        n, nf = tr.shape
        self.y = y.long()
        self.Z = torch.cat([tr, tr.new_ones((n, 1))], dim=1)
        A = (self.Z.T @ self.Z) / n
        ridge = 1e-6 * torch.trace(A) / (nf + 1)
        self.factor = torch.linalg.cholesky(
            A / 2 + ridge * torch.eye(nf + 1, device=tr.device))
        self.Y1 = F.one_hot(self.y, n_classes).to(tr.dtype)
        self.ts = torch.tensor(LINE_SEARCH, dtype=tr.dtype, device=tr.device)
        self.n = n

    def ce(self, logits: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy of a batch of logits ``[T, n, C]``."""
        lp = torch.log_softmax(logits, dim=-1)
        idx = self.y[None, :, None].expand(lp.shape[0], self.n, 1)
        return -lp.gather(-1, idx)[..., 0].mean(dim=1)

    @torch.no_grad()
    def step(self, theta: torch.Tensor):
        logits = self.Z @ theta
        P = torch.softmax(logits, dim=-1)
        G = self.Z.T @ (P - self.Y1) / self.n
        D = torch.cholesky_solve(G, self.factor)
        ZD = self.Z @ D
        losses = self.ce(logits[None] - self.ts[:, None, None] * ZD[None])
        best = torch.argmin(losses)
        return theta - self.ts[best] * D, losses[best]

    def zero(self, n_classes: int) -> torch.Tensor:
        return self.Z.new_zeros((self.Z.shape[1], n_classes))


def newton_to_parity(tr, y, n_classes: int, target_loss: float,
                     target_acc: float, max_iter: int = MAX_ITER,
                     emit=print) -> dict:
    """The Böhning iterations from a zero head against the oracle's loss
    and accuracy: ``{"iters": [(it, loss, acc)], "parity_iter": it or
    None}``; prints the reference's lines through ``emit``."""
    bo = Boehning(tr, y, n_classes)
    theta = bo.zero(n_classes)
    iters, parity = [], None
    for it in range(1, max_iter + 1):
        theta, loss_t = bo.step(theta)
        loss = float(loss_t)
        acc = accuracy(bo.Z @ theta, y)
        iters.append((it, loss, acc))
        emit(f"newton iter {it:2d}: loss {loss:.6f} acc {acc:.4f}"
             + ("  <= LBFGS" if loss <= target_loss else ""))
        if loss <= target_loss and acc >= target_acc:
            emit(f"parity at iter {it}")
            parity = it
            break
    return {"iters": iters, "parity_iter": parity}


def run(tr: torch.Tensor, y: torch.Tensor, params0, weight_decay: float = 0.0,
        max_iter: int = MAX_ITER, reps: int = REPS) -> dict:
    """The reference's lines from propagated rows ``tr`` and labels ``y``
    (on one device) and the oracle's start ``params0``; then the warm
    timings. Returns every number printed."""
    n, nf = tr.shape
    C = int(params0.w.shape[1])
    print(f"n={n} F={nf} C={C}")
    sync(tr.device)
    t0 = time.perf_counter()
    fit, loss_lb, acc_lb = lbfgs(tr, y, params0, weight_decay)
    sync(tr.device)
    t_lb = time.perf_counter() - t0
    print(f"LBFGS {LBFGS_EPOCHS} epochs ({LBFGS_EPOCHS * 20} iters): loss "
          f"{loss_lb:.6f} train-acc {acc_lb:.4f}  [{t_lb:.1f}s incl first "
          "call]")
    out = newton_to_parity(tr, y, C, loss_lb, acc_lb, max_iter)
    out.update(lbfgs_loss=loss_lb, lbfgs_acc=acc_lb, lbfgs_first_s=t_lb)

    # warm timings, each the best of reps runs closed by a sync
    out["lbfgs_ms"] = best_seconds(
        lambda: lbfgs(tr, y, params0, weight_decay)[0].w, reps)[0] * 1e3
    bo = Boehning(tr, y, C)
    out["factor_ms"] = best_seconds(
        lambda: Boehning(tr, y, C).factor, reps)[0] * 1e3
    theta0 = bo.zero(C)
    out["newton_iter_ms"] = best_seconds(
        lambda: bo.step(theta0)[0], reps)[0] * 1e3
    n_to_parity = out["parity_iter"] or max_iter

    def fit_to_parity():
        b = Boehning(tr, y, C)
        theta = b.zero(C)
        for _ in range(n_to_parity):
            theta, _ = b.step(theta)
        return theta

    out["newton_to_parity_ms"] = best_seconds(fit_to_parity, reps)[0] * 1e3
    cw = torch.ones(C, device=tr.device)
    out["package_newton_ms"] = best_seconds(
        lambda: _newton_linear_fit(params0, tr, y, weight_decay, cw,
                                   PACKAGE_NEWTON_STEPS, False, False)[0].w,
        reps)[0] * 1e3
    print(f"warm: LBFGS {out['lbfgs_ms']:.2f} ms, factor "
          f"{out['factor_ms']:.2f} ms, one iteration "
          f"{out['newton_iter_ms']:.2f} ms, {n_to_parity} iterations "
          f"{out['newton_to_parity_ms']:.2f} ms; the package's "
          f"{PACKAGE_NEWTON_STEPS}-step Newton head "
          f"{out['package_newton_ms']:.2f} ms")
    return out


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("scale", type=float, nargs="?", default=0.25)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    print(f"backend: {backend(dev)}")
    tr, y, _ = propagated(a.scale, dev)
    C = int(y.max()) + 1
    params0 = init_sgc(torch.Generator().manual_seed(42), tr.shape[1], C,
                       device=dev)
    run(tr, y, params0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
