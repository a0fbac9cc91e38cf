"""Deep GCN stacks (the counterpart of sgc_tpu/models/deep_gcn.py):
an input projection, ``L - 2`` homogeneous hidden layers with optional
residuals, an output projection; every layer ``relu(S @ (h W + b))``
through ``spmm``'s differentiable path (kernel B, and kernel B over the
transpose backward), recorded under GCN's span ``gcn.spmm``.

The hidden layers' parameters stay stacked, ``w_hidden [L-2, H, H]`` and
``b_hidden [L-2, H]``, as single parameters, so the reference's arrays
carry across unchanged (:func:`params_from_jax`). The reference scans
them with ``lax.scan``; here a loop over the leading axis runs them.
``remat=True`` wraps each hidden layer in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, the
counterpart of ``jax.checkpoint``: the backward recomputes the layer,
relaunching kernel B, which sums in a fixed order, so the loss and the
gradients are the same bits either way.

:func:`stage_layers` groups the stacked hidden layers into contiguous
pipeline stages, a layout hook as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models.gcn import SPAN
from sgc_tpu_torch.ops.spmm import spmm
from sgc_tpu_torch.utils.device import resolve_device

_FIELDS = ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")


class DeepGCN(nn.Module):
    """``w_in [F, H]``, ``b_in [H]``, ``w_hidden [L-2, H, H]``,
    ``b_hidden [L-2, H]``, ``w_out [H, C]``, ``b_out [C]``."""

    def __init__(self, w_in, b_in, w_hidden, b_hidden, w_out, b_out):
        super().__init__()
        for name, t in zip(_FIELDS, (w_in, b_in, w_hidden, b_hidden, w_out,
                                     b_out)):
            setattr(self, name, nn.Parameter(t))

    @property
    def n_layers(self) -> int:
        return 2 + int(self.w_hidden.shape[0])


def init_deep_gcn(generator: torch.Generator, nfeat: int, nhid: int,
                  nclass: int, n_layers: int, device=None) -> DeepGCN:
    """Glorot-normal weights, N(0, 2 / (fan_in + fan_out)), drawn in layer
    order from ``generator``; zero biases (deep_gcn.py:52-74)."""
    if n_layers < 2:
        raise ValueError("deep GCN needs >= 2 layers")
    dev = resolve_device(device)
    gdev = generator.device

    def glorot(fan_in, fan_out):
        return torch.empty((fan_in, fan_out), device=gdev).normal_(
            0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)

    n_hidden = n_layers - 2
    w_in = glorot(nfeat, nhid)
    w_h = (torch.stack([glorot(nhid, nhid) for _ in range(n_hidden)])
           if n_hidden else torch.zeros((0, nhid, nhid), device=gdev))
    w_out = glorot(nhid, nclass)
    return DeepGCN(*(t.to(dev) for t in (
        w_in, torch.zeros(nhid), w_h, torch.zeros((n_hidden, nhid)), w_out,
        torch.zeros(nclass))))


def params_from_jax(params, device=None) -> DeepGCN:
    """A DeepGCN holding the values of the reference's ``DeepGCNParams``
    (any object with the six arrays)."""
    dev = resolve_device(device)
    return DeepGCN(*(torch.tensor(np.asarray(getattr(params, k), np.float32),
                                  device=dev) for k in _FIELDS))


def _hidden_layer(h, w, b, graph, residual, impl):
    out = torch.relu(spmm(graph, h @ w + b, impl=impl, span_name=SPAN))
    return out + h if residual else out


def deep_gcn_apply(model: DeepGCN, x: torch.Tensor, graph: SparseGraph, *,
                   residual: bool = True, remat: bool = True,
                   impl: str = "auto") -> torch.Tensor:
    """Logits ``[n, C]``: in-projection, the hidden layers ``h <-
    relu(S @ (h W + b)) (+ h)``, out-projection (deep_gcn.py:77-104).

    Kernel B walks ``graph``'s rows in a community order only where the
    graph is prepared (``ops.autograd.prepare_operator``, once, before
    the steps) and a layer's table outgrows the card's L2; a graph passed
    as it is launches in index order however deep the stack. Preparing
    repays its LPA run only over many steps of a deep or wide stack on a
    large graph whose ids scatter its communities."""
    h = torch.relu(spmm(graph, x @ model.w_in + model.b_in, impl=impl,
                        span_name=SPAN))
    for i in range(int(model.w_hidden.shape[0])):
        w, b = model.w_hidden[i], model.b_hidden[i]
        if remat:
            h = checkpoint(_hidden_layer, h, w, b, graph, residual, impl,
                           use_reentrant=False)
        else:
            h = _hidden_layer(h, w, b, graph, residual, impl)
    return spmm(graph, h @ model.w_out + model.b_out, impl=impl,
                span_name=SPAN)


def stage_layers(model: DeepGCN, n_stages: int):
    """The hidden layers in ``ceil((L-2) / n_stages)``-layer contiguous
    groups: a list of ``(w_stack, b_stack)`` views (deep_gcn.py:107-121)."""
    n_hidden = int(model.w_hidden.shape[0])
    if n_stages <= 0 or n_hidden == 0:
        return [(model.w_hidden, model.b_hidden)]
    per = -(-n_hidden // n_stages)
    return [(model.w_hidden[s: s + per], model.b_hidden[s: s + per])
            for s in range(0, n_hidden, per)]
