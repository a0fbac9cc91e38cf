"""Graph attention layer (the counterpart of sgc_tpu/models/gat.py), the
Velickovic et al. 2018 formulation on the port's sparse kernels:

    e_uv  = LeakyReLU(a_dst . h_v + a_src . h_u)   rank-1 edge logits
    alpha = segment_softmax(e)                      per destination row
    h'_v  = sum_u alpha_uv h_u  (+ bias)            SpMM, kernel B

Each sparse step is a Function of ``ops/autograd.py``, so the backward
runs on the kernels too: the gradient of the attention values is an
SDDMM (kernel D), that of ``h`` kernel B over the transpose, and the
logits, the softmax and their gradients the row-walking kernels of
``csrc/edge_softmax.cu``. No gradient goes through an atomic scatter, so
training repeats to the same bits.

Heads are a leading axis of stacked parameters (:func:`init_multi_head`),
looped over where the reference vmaps; ``multi_head_gat`` concatenates
head-major, ``(n, H * F)``, or averages.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops.autograd import EdgeScoresFn, SegmentSoftmaxFn
from sgc_tpu_torch.ops.spmm import spmm
from sgc_tpu_torch.utils.device import resolve_device


class GATLayer(nn.Module):
    """``w [.., F_in, F_out]``, ``a_src``, ``a_dst``, ``bias [.., F_out]``;
    a leading head axis when stacked."""

    def __init__(self, w: torch.Tensor, a_src: torch.Tensor,
                 a_dst: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.w, self.a_src = nn.Parameter(w), nn.Parameter(a_src)
        self.a_dst, self.bias = nn.Parameter(a_dst), nn.Parameter(bias)

    @property
    def n_heads(self) -> int:
        return int(self.w.shape[0]) if self.w.dim() == 3 else 1


def _draw(generator, f_in: int, f_out: int, n_heads: int | None):
    """w, a_src, a_dst for each head in turn from ``generator``, then a
    zero bias; stacked on a leading axis when ``n_heads`` is given."""
    dev = generator.device
    std = math.sqrt(2.0 / (f_in + f_out))
    heads = []
    for _ in range(n_heads or 1):
        heads.append(tuple(
            torch.empty(shape, device=dev).normal_(0.0, sd,
                                                   generator=generator)
            for shape, sd in (((f_in, f_out), std), ((f_out,), 0.1),
                              ((f_out,), 0.1))))
    w, a_src, a_dst = (torch.stack(t) for t in zip(*heads))
    if n_heads is None:
        w, a_src, a_dst = w[0], a_src[0], a_dst[0]
    lead = () if n_heads is None else (n_heads,)
    return w, a_src, a_dst, torch.zeros(lead + (f_out,), device=dev)


def init_gat_layer(generator: torch.Generator, f_in: int, f_out: int,
                   device=None) -> GATLayer:
    """One head: Glorot-normal ``w``, N(0, 0.1^2) attention vectors, zero
    bias (gat.py:46-56), drawn from ``generator``."""
    dev = resolve_device(device)
    return GATLayer(*(t.to(dev) for t in _draw(generator, f_in, f_out,
                                                None)))


def init_multi_head(generator: torch.Generator, n_heads: int, f_in: int,
                    f_out: int, device=None) -> GATLayer:
    """Stacked heads (leading axis = head) for :func:`multi_head_gat`."""
    dev = resolve_device(device)
    return GATLayer(*(t.to(dev) for t in _draw(generator, f_in, f_out,
                                                n_heads)))


def params_from_jax(params, device=None) -> GATLayer:
    """A layer (or stack of heads) holding the reference's
    ``GATLayerParams`` values (any object with ``w``, ``a_src``,
    ``a_dst``, ``bias``)."""
    dev = resolve_device(device)
    return GATLayer(*(torch.tensor(np.asarray(getattr(params, k),
                                              np.float32), device=dev)
                      for k in ("w", "a_src", "a_dst", "bias")))


def segment_softmax(logits: torch.Tensor,
                    graph: SparseGraph) -> torch.Tensor:
    """Softmax over each row's live edges ``[0, nnz)``, 0 on padding; the
    reference's ``segment_softmax(logits, graph.rows, graph.n_rows,
    live)`` with its positional ``live``."""
    return SegmentSoftmaxFn.apply(graph, logits)


def _attend(h, a_src, a_dst, bias, graph, negative_slope, activation,
            impl):
    """One head on its transformed features ``h = x @ w``."""
    logits = EdgeScoresFn.apply(graph, h @ a_dst, h @ a_src, negative_slope)
    alpha = segment_softmax(logits, graph)
    out = spmm(graph.with_vals(alpha), h, impl=impl,
               span_name="gat.spmm") + bias
    return activation(out) if activation is not None else out


def gat_layer_apply(layer: GATLayer, x: torch.Tensor, graph: SparseGraph, *,
                    negative_slope: float = 0.2, activation=F.elu,
                    impl: str = "auto") -> torch.Tensor:
    """One attention layer, f32 ``[n_rows, F_out]`` (gat.py:80-116).
    ``impl`` other than ``auto``/``segment``/``chunked`` serves inference
    only (those impls have no gradient)."""
    return _attend(x @ layer.w, layer.a_src, layer.a_dst, layer.bias, graph,
                   negative_slope, activation, impl)


def multi_head_gat(layer: GATLayer, x: torch.Tensor, graph: SparseGraph, *,
                   concat: bool = True, negative_slope: float = 0.2,
                   activation=F.elu, impl: str = "auto") -> torch.Tensor:
    """Every head of a stacked layer, the heads' dense products in one
    batched matmul: ``concat=True`` gives ``(n, H * F_out)`` head-major
    (hidden layers), ``False`` the mean over heads (output layer)."""
    hs = torch.matmul(x, layer.w)                  # (H, n, F_out)
    outs = [_attend(hs[i], layer.a_src[i], layer.a_dst[i], layer.bias[i],
                    graph, negative_slope, activation, impl)
            for i in range(layer.n_heads)]
    if concat:
        return torch.cat(outs, dim=1)
    return torch.stack(outs).mean(dim=0)
