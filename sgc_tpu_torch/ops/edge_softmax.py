"""GAT's attention coefficients on a graph's edges (the counterpart of the
logits and ``segment_softmax`` of sgc_tpu/models/gat.py:59-104): five
entries of ``csrc/edge_softmax.cu``, each with its plain version.

* :func:`edge_scores` ``logits[e] = leaky(pre[e])`` with ``pre[e] =
  dst[rows[e]] + src[cols[e]]`` over the ``E_pad`` slots (the rank-1
  SDDMM of GAT's logits with its LeakyReLU), and the byte mask ``pre >
  0`` that its backward takes in place of ``pre``;
* :func:`edge_softmax` the softmax of the logits over each row's live
  edges, 0 on padding;
* :func:`edge_softmax_grad` its backward, ``alpha (g - s[rows])`` with
  ``s`` each row's sum of ``alpha g``, 0 on padding;
* :func:`edge_scores_grad` the scores' backward: each row's and each
  column's sum of the gradient through the leaky ReLU, two launches
  (``edge_scores_grad_dst`` over the rows, which also writes each edge's
  term at its place in the graph's transpose; ``edge_scores_grad_src``
  over the transpose's rows). The caller passes the transpose and those
  places (``ops.autograd.transpose_places``).

Edges are live by position, ``[0, nnz)``, as ``sddmm``'s padding: a row's
softmax covers exactly its ``row_ptr`` range. The plain versions are the
composition the port ran before the kernels (``index_select`` gathers,
an ``amax`` scatter, elementwise passes and kernel B's F = 1 row sums,
``ops.spmm.row_sums``): the CPU runs them, and on the card they give the kernels'
bits, which the card tests hold. A CUDA tensor always takes the kernel.
Each launch counts ``launch.<entry>``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.spmm import row_sums
from sgc_tpu_torch.utils.profiling import count

# the C entries, each counted as launch.<entry>
ENTRIES = ("edge_scores", "edge_softmax", "edge_softmax_grad",
           "edge_scores_grad_dst", "edge_scores_grad_src")


# ------------------------------------------------------------ plain versions

def edge_scores_plain(graph: SparseGraph, dst: torch.Tensor,
                      src: torch.Tensor, slope: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    pre = dst.index_select(0, graph.rows) + src.index_select(0, graph.cols)
    return F.leaky_relu(pre, slope), pre > 0


def edge_softmax_plain(graph: SparseGraph,
                       logits: torch.Tensor) -> torch.Tensor:
    """The reference's constants: the dead slots at ``finfo(f32).min``
    in the max, a row with no edge at max 0, the denominator clamped at
    1e-30."""
    live = (torch.arange(graph.n_edges_padded, device=logits.device)
            < graph.nnz)
    rows = graph.rows.long()
    neg = torch.finfo(torch.float32).min
    masked = torch.where(live, logits, neg)
    seg_max = logits.new_zeros(graph.n_rows).scatter_reduce(
        0, rows, masked, "amax", include_self=False)
    ex = torch.where(live, torch.exp(logits - seg_max[rows]), 0.0)
    denom = row_sums(graph, ex)
    return ex / denom[rows].clamp_min(1e-30)


def edge_softmax_grad_plain(graph: SparseGraph, alpha: torch.Tensor,
                            g: torch.Tensor) -> torch.Tensor:
    s = row_sums(graph, alpha * g)
    d = alpha * (g - s.index_select(0, graph.rows))
    d[graph.nnz:] = 0.0
    return d


def edge_scores_grad_plain(graph: SparseGraph, d: torch.Tensor,
                           mask: torch.Tensor, slope: float,
                           transpose=None):
    """``(d_dst, d_src)``; ``d_src`` None without ``transpose``, ``(gt,
    places)`` as :func:`edge_scores_grad` takes it: the column sums are
    the transpose's row sums of the terms stored at their places."""
    gl = torch.where(mask, d, d * slope)
    if transpose is None:
        return row_sums(graph, gl), None
    gt, places = transpose
    gl_t = gl.new_zeros(gt.n_edges_padded)
    gl_t[places.long()] = gl[: graph.nnz]
    return row_sums(graph, gl), row_sums(gt, gl_t)


# ------------------------------------------------------------------ entries

def _check(graph: SparseGraph, **tensors) -> None:
    """Each operand contiguous f32 on the card, of ``[n_rows]`` (``dst``),
    ``[n_cols]`` (``src``) or ``[E_pad]`` (an edge array); the graph's
    index arrays contiguous int32."""
    shapes = {"dst": graph.n_rows, "src": graph.n_cols}
    for name, t in tensors.items():
        kernels.require_cuda_f32(
            t, name, (shapes.get(name, graph.n_edges_padded),))
    for name, t in (("row_ptr", graph.row_ptr), ("rows", graph.rows),
                    ("cols", graph.cols)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"graph.{name} must be contiguous int32")


def _launch(entry: str, *args) -> None:
    """One launch of C entry ``entry`` (tensors passed as their device
    pointers); raises when it fails."""
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    kernels.check_launch(kernels.entry("edge_softmax", entry)(*args), entry)
    count(f"launch.{entry}")


def edge_scores(graph: SparseGraph, dst: torch.Tensor, src: torch.Tensor,
                slope: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(leaky(pre, slope), pre > 0)`` for ``pre = dst[rows] +
    src[cols]``: f32 and bool ``[E_pad]``; ``dst`` ``[n_rows]``, ``src``
    ``[n_cols]``, contiguous f32."""
    if dst.device.type == "cpu":
        return edge_scores_plain(graph, dst, src, slope)
    _check(graph, dst=dst, src=src)
    out = torch.empty(graph.n_edges_padded, dtype=torch.float32,
                      device=dst.device)
    mask = torch.empty(graph.n_edges_padded, dtype=torch.bool,
                       device=dst.device)
    _launch("edge_scores", graph.row_ptr, graph.rows, graph.cols, dst, src,
            out, mask, graph.n_rows, graph.nnz, graph.n_edges_padded, slope,
            kernels.stream_of(dst))
    return out, mask


def edge_softmax(graph: SparseGraph, logits: torch.Tensor) -> torch.Tensor:
    """The softmax of ``logits`` (f32 ``[E_pad]``) over each row's live
    edges, 0 on padding."""
    if logits.device.type == "cpu":
        return edge_softmax_plain(graph, logits)
    _check(graph, logits=logits)
    out = torch.empty_like(logits)
    _launch("edge_softmax", graph.row_ptr, logits, out, graph.n_rows,
            graph.nnz, graph.n_edges_padded, kernels.stream_of(logits))
    return out


def edge_softmax_grad(graph: SparseGraph, alpha: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """The gradient of the logits from ``g``, that of :func:`edge_softmax`'s
    output ``alpha``: ``alpha (g - s[rows])``, 0 on padding."""
    if alpha.device.type == "cpu":
        return edge_softmax_grad_plain(graph, alpha, g)
    _check(graph, alpha=alpha, g=g)
    out = torch.empty_like(alpha)
    _launch("edge_softmax_grad", graph.row_ptr, alpha, g, out, graph.n_rows,
            graph.nnz, graph.n_edges_padded, kernels.stream_of(alpha))
    return out


def edge_scores_grad(graph: SparseGraph, d: torch.Tensor, mask: torch.Tensor,
                     slope: float, transpose=None):
    """``(d_dst, d_src)`` from the logits' gradient ``d`` and
    :func:`edge_scores`' mask: each row's and each column's sum, in edge
    order (the columns' in the transpose's), of ``d`` through the leaky
    ReLU, f32 ``[n_rows]`` and ``[n_cols]``. ``transpose`` is ``(gt,
    places)``: the graph's transpose and int32 ``[nnz]``, each live
    edge's place in it (``ops.autograd.transpose_places``); ``d_src`` is
    None without it."""
    if d.device.type == "cpu":
        return edge_scores_grad_plain(graph, d, mask, slope, transpose)
    _check(graph, d=d)
    if (mask.dtype != torch.bool or not mask.is_contiguous()
            or tuple(mask.shape) != (graph.n_edges_padded,)
            or mask.device != d.device):
        raise ValueError("mask must be a contiguous bool [E_pad] tensor "
                         "on d's device")
    d_dst = torch.empty(graph.n_rows, dtype=torch.float32, device=d.device)
    if transpose is None:
        _launch("edge_scores_grad_dst", graph.row_ptr, d, mask, None, d_dst,
                None, graph.n_rows, slope, kernels.stream_of(d))
        return d_dst, None
    gt, places = transpose
    if (places.dtype != torch.int32 or not places.is_contiguous()
            or tuple(places.shape) != (graph.nnz,)
            or places.device != d.device or gt.nnz != graph.nnz):
        raise ValueError("places must be contiguous int32 [nnz] on d's "
                         "device, of a transpose of the graph")
    gl_t = torch.empty(graph.nnz, dtype=torch.float32, device=d.device)
    d_src = torch.empty(graph.n_cols, dtype=torch.float32, device=d.device)
    _launch("edge_scores_grad_dst", graph.row_ptr, d, mask, places, d_dst,
            gl_t, graph.n_rows, slope, kernels.stream_of(d))
    _launch("edge_scores_grad_src", gt.row_ptr, gl_t, d_src, graph.n_cols,
            kernels.stream_of(d))
    return d_dst, d_src
