"""Two-layer GCN (the counterpart of sgc_tpu/models/gcn.py).

Each layer is a dense product, its bias, then the SpMM with the
normalized adjacency, so the bias is added before the propagation, as in
the reference (gcn.py:67,74); ReLU and dropout sit between the layers.
The propagation runs inside every training step, so both SpMMs go
through ``spmm``'s differentiable path (``ops/autograd.py``): kernel B
forward and kernel B over the transpose backward, each recorded under
the span ``gcn.spmm``.

The parameters keep the reference's layout, ``w1 [F, H]``, ``b1 [H]``,
``w2 [H, C]``, ``b2 [C]``, so they carry across unchanged
(:func:`params_from_jax`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops.spmm import spmm
from sgc_tpu_torch.utils.device import resolve_device

# the span of both differentiable products (and the deep stack's)
SPAN = "gcn.spmm"


class GCN(nn.Module):
    """Parameters ``w1``, ``b1``, ``w2``, ``b2``; :func:`gcn_apply` is the
    forward pass."""

    def __init__(self, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)


def _uniform(generator: torch.Generator, shape, fan_in: int):
    stdv = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.uniform_(-stdv, stdv, generator=generator)


def init_gcn(generator: torch.Generator, nfeat: int, nhid: int, nclass: int,
             device=None) -> GCN:
    """A new GCN drawn from ``generator`` (w1, b1, w2, b2 in that order),
    each layer U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (gcn.py:38-54), placed
    on ``device`` (``None`` -> the card)."""
    dev = resolve_device(device)
    w1 = _uniform(generator, (nfeat, nhid), nfeat)
    b1 = _uniform(generator, (nhid,), nfeat)
    w2 = _uniform(generator, (nhid, nclass), nhid)
    b2 = _uniform(generator, (nclass,), nhid)
    return GCN(*(t.to(dev) for t in (w1, b1, w2, b2)))


def params_from_jax(params, device=None) -> GCN:
    """A GCN holding the values of the reference's ``GCNParams`` (any
    object with arrays ``w1``, ``b1``, ``w2``, ``b2``)."""
    dev = resolve_device(device)
    return GCN(*(torch.tensor(np.asarray(getattr(params, k), np.float32),
                              device=dev) for k in ("w1", "b1", "w2", "b2")))


def gcn_apply(model: GCN, x: torch.Tensor, graph: SparseGraph, *,
              use_relu: bool = True, dropout_rate: float = 0.0,
              generator: torch.Generator | None = None,
              keep_mask: torch.Tensor | None = None,
              impl: str = "auto") -> torch.Tensor:
    """Logits ``[n, C]``: ``S @ (drop(relu(S @ (x w1 + b1))) w2 + b2)``.

    Dropout runs when ``dropout_rate > 0`` and either a ``generator`` (on
    x's device) draws the keep mask or ``keep_mask`` gives it (a test
    passes the reference's ``jax.random.bernoulli`` mask); kept entries
    are scaled by ``1 / (1 - dropout_rate)``.
    """
    h = spmm(graph, x @ model.w1 + model.b1, impl=impl,
             span_name=SPAN)
    if use_relu:
        h = torch.relu(h)
    if dropout_rate > 0.0 and (keep_mask is not None
                               or generator is not None):
        keep = 1.0 - dropout_rate
        if keep_mask is None:
            keep_mask = torch.rand(h.shape, generator=generator,
                                   device=h.device) < keep
        h = torch.where(keep_mask, h / keep, 0.0)
    return spmm(graph, h @ model.w2 + model.b2, impl=impl,
                span_name=SPAN)
