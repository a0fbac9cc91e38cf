"""Train-statistic feature scaling, TextSGC's min-max (the counterpart of
sgc_tpu/ops/scaling.py).

Per-feature min and range are fit on the train split, dimensions with
zero range are dropped, and the same affine map is applied to val and
test. ``keep`` is a host array: which dimensions survive is read back
once, at fit time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MinMaxStats:
    keep: np.ndarray        # int64 indices of the dims with range > 0
    mins: torch.Tensor      # float32[len(keep)]
    ranges: torch.Tensor    # float32[len(keep)]


def fit_minmax(train_feats: torch.Tensor) -> MinMaxStats:
    """Per-feature min and range of the train matrix; zero-range dims
    dropped."""
    mins = train_feats.min(dim=0).values
    ranges = train_feats.max(dim=0).values - mins
    keep = np.flatnonzero(ranges.cpu().numpy() > 0)
    idx = torch.as_tensor(keep, device=train_feats.device)
    return MinMaxStats(keep=keep, mins=mins[idx], ranges=ranges[idx])


def apply_minmax(stats: MinMaxStats, feats: torch.Tensor) -> torch.Tensor:
    """``(feats[:, keep] - min) / range``."""
    idx = torch.as_tensor(stats.keep, device=feats.device)
    return (feats[:, idx] - stats.mins[None, :]) / stats.ranges[None, :]
