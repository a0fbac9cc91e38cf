"""GCNII (Chen, Wei, Huang, Ding and Li, "Simple and Deep Graph
Convolutional Networks", ICML 2020): a deep GCN whose every layer keeps
an initial residual to the first layer's output and an identity mapping
whose weight share falls with depth:

    h0  = relu(x W_in + b_in)
    s_l = (1 - alpha) S h_{l-1} + alpha h0                 initial residual
    h_l = relu((1 - beta_l) s_l + beta_l s_l W_l),  beta_l = ln(lamda / l + 1)
    out = h_L W_out + b_out

Dropout (when ``dropout > 0`` and a generator draws it) falls on x, on
each layer's input and on h_L, not on the residual ``h0``, as the
authors' code applies it.

The propagation is one launch of kernel B a layer through ``spmm``'s
differentiable path with a dense operand: ``S' h + alpha h0``, where
``S' = (1 - alpha) S`` is built once (:func:`scaled_operator`) and
``alpha h0`` once a forward. The backward is kernel B over the transpose
of ``S'`` that the operator carries with its values, so no backward
product gathers them; ``alpha h0`` takes the output's gradient as it is.
The row order kernel B walks ``S'`` and its transpose in (LPA's, on a
graph whose ids scatter its communities) is decided and built with the
operator, once (ops/autograd.py::prepare_operator); a product walks it
where its table outgrows the card's L2. Each forward and backward of a
layer's propagation is a span ``gcnii.prop``.

Departure from the authors' two-term form: the identity mapping is one
product, ``s_l ((1 - beta_l) I + beta_l W_l)``, equal in exact
arithmetic and rounded once instead of twice.

The conv weights are stacked, ``w_conv [L, H, H]``, as the deep GCN's
hidden layers are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops.autograd import prepare_operator
from sgc_tpu_torch.ops.spmm import spmm
from sgc_tpu_torch.utils.device import resolve_device

SPAN = "gcnii.prop"
_FIELDS = ("w_in", "b_in", "w_conv", "w_out", "b_out")


class GCNII(nn.Module):
    """``w_in [F, H]``, ``b_in [H]``, ``w_conv [L, H, H]``, ``w_out [H,
    C]``, ``b_out [C]``; :func:`gcnii_apply` is the forward pass."""

    def __init__(self, w_in, b_in, w_conv, w_out, b_out):
        super().__init__()
        for name, t in zip(_FIELDS, (w_in, b_in, w_conv, w_out, b_out)):
            setattr(self, name, nn.Parameter(t))

    @property
    def n_layers(self) -> int:
        return int(self.w_conv.shape[0])

    def conv_params(self) -> list:
        """The convolution weights (the authors' ``params1``)."""
        return [self.w_conv]

    def dense_params(self) -> list:
        """The two dense layers' weights and biases (``params2``)."""
        return [self.w_in, self.b_in, self.w_out, self.b_out]


def _uniform(generator: torch.Generator, shape, bound: float):
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.uniform_(-bound, bound, generator=generator)


def init_gcnii(generator: torch.Generator, nfeat: int, nhid: int,
               nclass: int, n_layers: int, device=None) -> GCNII:
    """A new GCNII drawn from ``generator`` in the order w_in, b_in, the
    conv weights layer by layer, w_out, b_out: the conv weights uniform in
    ``+-1/sqrt(H)`` (the authors' rule), the dense layers by
    ``nn.Linear``'s, uniform in ``+-1/sqrt(fan_in)``; placed on
    ``device`` (``None`` -> the card)."""
    if n_layers < 1:
        raise ValueError("GCNII needs >= 1 layer")
    dev = resolve_device(device)
    w_in = _uniform(generator, (nfeat, nhid), 1.0 / math.sqrt(nfeat))
    b_in = _uniform(generator, (nhid,), 1.0 / math.sqrt(nfeat))
    w_conv = _uniform(generator, (n_layers, nhid, nhid),
                      1.0 / math.sqrt(nhid))
    w_out = _uniform(generator, (nhid, nclass), 1.0 / math.sqrt(nhid))
    b_out = _uniform(generator, (nclass,), 1.0 / math.sqrt(nhid))
    return GCNII(*(t.to(dev) for t in (w_in, b_in, w_conv, w_out, b_out)))


def scaled_operator(graph: SparseGraph, alpha: float) -> SparseGraph:
    """``S' = (1 - alpha) S`` on ``graph``'s pattern, prepared
    (``ops.autograd.prepare_operator``): its transpose with its values,
    and the rows of both in kernel B's order. Build it once and pass it
    to every :func:`gcnii_apply`."""
    return prepare_operator(graph.with_vals(graph.vals * (1.0 - alpha)))


def beta(lamda: float, layer: int) -> float:
    """The identity mapping's weight share of layer ``layer`` (from 1)."""
    return math.log(lamda / layer + 1.0)


def _drop(h: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Dropout as ``gcn_apply`` draws it: a keep mask from ``generator``,
    kept entries scaled by ``1 / (1 - rate)``."""
    if rate <= 0.0 or generator is None:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, 0.0)


def gcnii_apply(model: GCNII, x: torch.Tensor, graph_scaled: SparseGraph,
                alpha: float, lamda: float, dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Logits ``[n, C]`` of the layer equations above; ``graph_scaled``
    is :func:`scaled_operator` of ``S`` at the same ``alpha``."""
    h0 = torch.relu(_drop(x, dropout, generator) @ model.w_in + model.b_in)
    residual = alpha * h0
    eye = torch.eye(h0.shape[1], dtype=h0.dtype, device=h0.device)
    h = h0
    for i in range(model.n_layers):
        s = spmm(graph_scaled, _drop(h, dropout, generator),
                 dense=residual, span_name=SPAN)
        b = beta(lamda, i + 1)
        h = torch.relu(s @ torch.lerp(eye, model.w_conv[i], b))
    return _drop(h, dropout, generator) @ model.w_out + model.b_out
