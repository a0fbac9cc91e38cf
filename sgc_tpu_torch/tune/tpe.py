"""Tree-structured Parzen Estimator (TPE) hyperparameter search (the
port's own copy of sgc_tpu/tune/tpe.py, which cannot be imported here:
``sgc_tpu/__init__.py`` imports JAX).

A native implementation of the TPE algorithm (Bergstra et al., NeurIPS
2011, the algorithm behind hyperopt's ``tpe.suggest``). Supports the
search-space primitives the tuning CLI uses: ``loguniform`` (weight
decay) plus ``uniform`` and ``choice``. Pure numpy: with the same seed
and the same objective values it suggests the same points as the
reference, bit for bit.

Algorithm per trial (after ``n_startup`` random trials):
  1. split observations into the best gamma-quantile ("good") and rest,
  2. fit Parzen (KDE) densities l(x) over good and g(x) over bad points,
  3. draw ``n_candidates`` samples from l and keep the maximizer of
     l(x)/g(x) (expected-improvement proxy).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    kind: str                      # 'uniform' | 'loguniform' | 'choice'
    low: float = 0.0
    high: float = 1.0
    choices: tuple = ()

    def to_internal(self, value):
        if self.kind == "loguniform":
            return math.log(value)
        if self.kind == "choice":
            return self.choices.index(value)
        return float(value)

    def from_internal(self, z: float):
        if self.kind == "loguniform":
            return math.exp(z)
        if self.kind == "choice":
            return self.choices[int(round(z))]
        return float(z)

    @property
    def internal_bounds(self) -> tuple[float, float]:
        if self.kind == "loguniform":
            return (math.log(self.low), math.log(self.high))
        if self.kind == "choice":
            return (0.0, len(self.choices) - 1.0)
        return (self.low, self.high)


def uniform(low: float, high: float) -> Param:
    return Param("uniform", low, high)


def loguniform(low: float, high: float) -> Param:
    """Bounds are raw values (NOT log-ed), unlike hyperopt's convention."""
    return Param("loguniform", low, high)


def choice(*options) -> Param:
    return Param("choice", choices=tuple(options))


class _Parzen1D:
    """Truncated-Gaussian Parzen mixture over an internal interval."""

    def __init__(self, points: np.ndarray, low: float, high: float):
        self.low, self.high = low, high
        # prior pseudo-point at the interval center keeps the density
        # proper with few observations
        center = 0.5 * (low + high)
        self.mus = np.sort(np.append(points, center))
        spread = high - low
        if len(self.mus) > 1:
            gaps = np.diff(self.mus)
            left = np.concatenate([[spread], gaps])
            right = np.concatenate([gaps, [spread]])
            sigma = np.maximum(left, right)
        else:
            sigma = np.full(1, spread)
        min_sigma = spread / max(100.0, len(self.mus) * 10.0)
        self.sigmas = np.clip(sigma, min_sigma, spread)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        comp = rng.integers(0, len(self.mus), n)
        z = rng.normal(self.mus[comp], self.sigmas[comp])
        return np.clip(z, self.low, self.high)

    def logpdf(self, z: np.ndarray) -> np.ndarray:
        z = np.asarray(z)[:, None]
        logp = (
            -0.5 * ((z - self.mus[None, :]) / self.sigmas[None, :]) ** 2
            - np.log(self.sigmas[None, :] * math.sqrt(2 * math.pi))
        )
        m = logp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(logp - m).mean(axis=1, keepdims=True))).ravel()


class TPESampler:
    def __init__(
        self,
        space: dict[str, Param],
        seed: int = 0,
        gamma: float = 0.25,
        n_startup: int = 20,
        n_candidates: int = 24,
    ):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.trials: list[tuple[dict, float]] = []

    def _random_point(self) -> dict:
        out = {}
        for name, p in self.space.items():
            lo, hi = p.internal_bounds
            if p.kind == "choice":
                z = float(self.rng.integers(0, len(p.choices)))
            else:
                z = float(self.rng.uniform(lo, hi))
            out[name] = p.from_internal(z)
        return out

    def suggest(self) -> dict:
        if len(self.trials) < self.n_startup:
            return self._random_point()
        losses = np.asarray([l for _, l in self.trials])
        order = np.argsort(losses)
        n_good = max(1, int(math.ceil(self.gamma * len(order))))
        good = [self.trials[i][0] for i in order[:n_good]]
        bad = [self.trials[i][0] for i in order[n_good:]]

        out = {}
        for name, p in self.space.items():
            lo, hi = p.internal_bounds
            zg = np.asarray([p.to_internal(t[name]) for t in good])
            zb = np.asarray([p.to_internal(t[name]) for t in bad])
            lmodel = _Parzen1D(zg, lo, hi)
            gmodel = _Parzen1D(zb, lo, hi)
            cand = lmodel.sample(self.rng, self.n_candidates)
            score = lmodel.logpdf(cand) - gmodel.logpdf(cand)
            out[name] = p.from_internal(float(cand[np.argmax(score)]))
        return out

    def observe(self, params: dict, loss: float) -> None:
        self.trials.append((params, float(loss)))

    @property
    def best(self) -> tuple[dict, float]:
        i = int(np.argmin([l for _, l in self.trials]))
        return self.trials[i]


def fmin(
    objective: Callable[[dict], float],
    space: dict[str, Param],
    max_evals: int = 60,
    seed: int = 0,
    verbose: bool = False,
) -> tuple[dict, float]:
    """Minimize ``objective`` over ``space``; returns (best_params,
    best_loss), the contract of hyperopt's ``fmin`` (max_evals=60 in the
    tuning CLI)."""
    sampler = TPESampler(space, seed=seed)
    for i in range(max_evals):
        params = sampler.suggest()
        loss = objective(params)
        sampler.observe(params, loss)
        if verbose:
            print(f"trial {i:3d}: loss={loss:.6f} params={params}")
    return sampler.best
