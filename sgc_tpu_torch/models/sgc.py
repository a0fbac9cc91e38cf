"""SGC head: logistic regression on K-hop-propagated features (the
counterpart of sgc_tpu/models/sgc.py).

The weight keeps the reference's layout, ``w: [nfeat, nclass]`` (not
``nn.Linear``'s transpose), so parameters carry across unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from sgc_tpu_torch.utils.device import resolve_device


class SGC(nn.Module):
    """``logits = x @ w (+ b)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        if b is None:
            self.register_parameter("b", None)
        else:
            self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.w
        if self.b is not None:
            out = out + self.b
        return out


def init_sgc(generator: torch.Generator, nfeat: int, nclass: int,
             bias: bool = True, device=None) -> SGC:
    """Torch's default ``nn.Linear`` init, U(-1/sqrt(nfeat), 1/sqrt(nfeat))
    for w and b, drawn from ``generator`` (w first, then b) on the
    generator's device and placed on ``device`` (``None`` -> the card)."""
    dev = resolve_device(device)
    bound = 1.0 / math.sqrt(nfeat)
    gdev = generator.device
    w = torch.empty((nfeat, nclass), dtype=torch.float32, device=gdev)
    w.uniform_(-bound, bound, generator=generator)
    b = None
    if bias:
        b = torch.empty((nclass,), dtype=torch.float32, device=gdev)
        b.uniform_(-bound, bound, generator=generator)
        b = b.to(dev)
    return SGC(w.to(dev), b)


def params_from_jax(w: np.ndarray, b: np.ndarray | None,
                    device=None) -> SGC:
    """An SGC head holding the reference's ``SGCParams`` values (passed as
    numpy arrays), so both packages can start from the same numbers."""
    dev = resolve_device(device)
    wt = torch.tensor(np.asarray(w, np.float32), device=dev)
    bt = None if b is None else torch.tensor(np.asarray(b, np.float32),
                                             device=dev)
    return SGC(wt, bt)


def sgc_apply(model: SGC, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: logits ``[n, nclass]``."""
    return model(x)
