"""Where the LBFGS oracle's time goes on the card (the counterpart of
scripts/exp_lbfgs_cost.py).

Times up to 40 LBFGS iterations at the Reddit train shape (152,410 x
602 seeded normal features, 41 classes, seeded labels; the head from
``init_sgc`` at seed 0) for history sizes 1, 5 and 40: if m = 1 costs
as much as m = 40, the two-loop recursion is not the cost, the
sequential loss-and-gradient evaluations are. The port's oracle is
``torch.optim.LBFGS`` (``max_iter=40``, ``lr=1``, one ``step``), the
optimizer the reference's ``lbfgs_minimize`` reimplements iteration for
iteration (tests/test_lbfgs_torch_oracle.py). Both stop early once the
loss changes by less than ``tolerance_change`` (1e-9): on this data
after a few iterations, since an f32 loss near ln 41 moves by whole
ulps (~2.4e-7) or not at all. The reference's line divides by 40
whatever ran; the port's counts the iterations run
(``state["n_iter"]``). Each time is the best of 3 runs after a warm
one, closed by a sync.

    python -m sgc_tpu_torch.scripts.exp_lbfgs_cost [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from sgc_tpu_torch.models.sgc import init_sgc
from sgc_tpu_torch.scripts import backend, best_seconds, device_parser
from sgc_tpu_torch.utils.device import resolve_device

N_TRAIN, N_FEATURES, N_CLASSES = 152_410, 602, 41
REPS = 3
ITERS = 40
HISTORY_SIZES = (1, 5, 40)


def make_inputs(n: int = N_TRAIN, f: int = N_FEATURES, c: int = N_CLASSES,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The reference's seeded x (standard normal, f32) and labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    return x, y


def lbfgs_fit(x: torch.Tensor, y: torch.Tensor, params0, history: int,
              iters: int = ITERS) -> tuple[torch.Tensor, int]:
    """At most ``iters`` LBFGS iterations of the mean softmax
    cross-entropy from ``params0``; returns the fitted (w, b) flattened
    (the reference's ``ravel_pytree`` order) and the iterations run."""
    w = params0.w.detach().clone().requires_grad_(True)
    b = params0.b.detach().clone().requires_grad_(True)
    opt = torch.optim.LBFGS([w, b], lr=1.0, max_iter=iters,
                            history_size=history)
    yl = y.long()

    def closure():
        opt.zero_grad()
        loss = F.cross_entropy(x @ w + b, yl)
        loss.backward()
        return loss

    opt.step(closure)
    return (torch.cat([w.detach().ravel(), b.detach().ravel()]),
            int(opt.state[w]["n_iter"]))


def run(x: torch.Tensor, y: torch.Tensor, params0,
        histories=HISTORY_SIZES, reps: int = REPS,
        iters: int = ITERS) -> dict:
    """Time each history size on placed ``x``, ``y``; prints the
    reference's line a size. Returns ``{m: {"ms", "iters",
    "ms_per_iter", "flat"}}``, ``flat`` the fitted parameters."""
    out = {}
    for m in histories:
        best, (flat, n) = best_seconds(
            lambda m=m: lbfgs_fit(x, y, params0, m, iters), reps)
        out[m] = {"ms": best * 1e3, "iters": n,
                  "ms_per_iter": best / n * 1e3, "flat": flat}
        print(f"m={m:3d}: {best * 1e3:7.1f} ms for {n} iters "
              f"({best / n * 1e3:.2f} ms/iter)", flush=True)
    return out


def main(argv=None) -> int:
    a = device_parser(__doc__).parse_args(argv)
    dev = resolve_device(a.device)
    print("backend:", backend(dev), flush=True)
    x, y = make_inputs(N_TRAIN, N_FEATURES, N_CLASSES)
    params0 = init_sgc(torch.Generator().manual_seed(0), N_FEATURES,
                       N_CLASSES, device=dev)
    run(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
        params0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
