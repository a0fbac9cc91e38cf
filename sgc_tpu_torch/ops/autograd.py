"""Gradients through the port's sparse kernels (the counterpart of what
JAX's autodiff derives from sgc_tpu/ops/spmm.py::spmm_segment and from the
gathers of sgc_tpu/models/gat.py).

The CUDA kernels are launched through ctypes, so autograd cannot see
into them: a tensor they return has no ``grad_fn``. Each product that a
model differentiates is therefore a ``torch.autograd.Function`` whose
backward is made of the port's kernels again. One set of Functions serves
both devices: on the CPU the wrappers run their plain versions, so the
CPU tests exercise the card's backward formulas.

* :class:`SpmmSegmentFn` ``(graph, vals, x) -> A @ x`` for ``A`` the
  graph's pattern with edge values ``vals``. Forward: kernel B. Backward:
  ``dx = A^T @ G`` is kernel B over the cached transpose, with
  ``vals[perm]`` gathered each call unless ``vals`` is the very tensor
  the transpose was built from (a graph with fixed values, as GCN's);
  ``dvals[e] = <G[rows[e]],
  x[cols[e]]>`` is an SDDMM, kernel D at ``"f32"``, computed only when
  ``vals`` needs a gradient.
* :class:`EdgeScoresFn` ``(graph, dst, src) -> dst[rows] + src[cols]``:
  the backward is a row sum of ``g`` (kernel B, F = 1, on the graph) and
  a column sum (kernel B, F = 1, over the transpose with ``g[perm]``).
* :class:`SegmentSoftmaxFn`: the softmax over each row's live edges with
  the reference's constants (sgc_tpu/models/gat.py:59-77); the
  denominator and the backward's ``rowsum(alpha * g)`` are kernel B row
  sums, the row max an ``amax`` scatter (max does not depend on the
  order, so its bits do not either).
* :class:`GatherRowsFn` ``(table, ids) -> table[ids]``: the embedding
  lookup of the transformer (sgc_tpu/models/transformer.py:196); the
  backward sums each id's gradient rows into its row with kernel B over
  ``ops.spmm.scatter_graph(ids)``, positions in increasing order, as
  the reference's sequential scatter-add does.

No backward here goes through ``index_add_``, ``scatter_add_`` or
``index_put_(accumulate=True)``: on CUDA those sum with float atomics in
an order that changes from run to run, and determinism is part of the
ops' contract (sgc_tpu/ops/spmm.py:18-24). Gathers (``index_select``) and
the kernels are deterministic, so a backward gives the same bits on
every run.

Padding edges ``[nnz, E_pad)``: the backwards read the live edges alone.
``dvals`` is 0 there (kernel D writes padding by position) where JAX's
gradient is ``<G[n_rows-1], x[n_cols-1]>``, and ``EdgeScoresFn`` adds
nothing from the padding's ``g``; the models mask those slots with
``where(live, ...)``, so their parameters' gradients agree.
"""

from __future__ import annotations

import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import spmm as _spmm
from sgc_tpu_torch.ops.spmm import scatter_graph, sddmm, spmm_segment
from sgc_tpu_torch.utils.buildcache import placed

# kernel B launches over a transpose (backward products), also counted in
# ops.spmm.LAUNCHES with every other kernel B launch
TRANSPOSED_LAUNCHES = 0


def _transpose_entry(graph: SparseGraph):
    """``(transpose, perm, source vals)``: the transpose is built on the
    host once for ``graph``'s pattern and cached by the pattern's arrays
    (``utils.buildcache.placed``), so every reweighting of one graph
    shares it; it carries the values of the first graph that asked,
    held (and pinned) as the third item."""
    return placed(graph, ("transpose",), graph.device,
                  lambda: (*graph.transpose_perm(), graph.vals),
                  lambda t, _dev: t, by_vals=False)[1]


def transposed(graph: SparseGraph):
    """``(transpose, perm)`` of ``graph``'s pattern on its device, from
    the cache of :func:`_transpose_entry`."""
    return _transpose_entry(graph)[:2]


def _edge_vals(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().float()


def on_transpose(graph: SparseGraph, vals: torch.Tensor) -> SparseGraph:
    """The transpose of ``graph`` carrying edge values ``vals`` (one per
    edge of ``graph``): ``vals[perm]`` on the live edges, 0 on padding.
    The cached transpose itself when ``vals`` is the tensor it was built
    from."""
    gt, perm, source = _transpose_entry(graph)
    if vals is source:
        return gt
    out = vals.new_zeros(gt.n_edges_padded)
    out[: graph.nnz] = vals.index_select(0, perm)
    return gt.with_vals(out)


def spmm_transposed(graph: SparseGraph, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """``A^T @ x`` for the pattern of ``graph`` with edge values
    ``vals``: kernel B over the cached transpose."""
    global TRANSPOSED_LAUNCHES
    before = _spmm.LAUNCHES
    out = spmm_segment(on_transpose(graph, _edge_vals(vals)), x)
    # the kernel's own launches: none for an empty product
    TRANSPOSED_LAUNCHES += _spmm.LAUNCHES - before
    return out


def row_sums(graph: SparseGraph, vals: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum of vals[e]`` over row r's live edges, f32
    ``[n_rows]``: kernel B with F = 1 against a column of ones."""
    ones = vals.new_ones((graph.n_cols, 1))
    return spmm_segment(graph.with_vals(_edge_vals(vals)), ones)[:, 0]


def col_sums(graph: SparseGraph, vals: torch.Tensor) -> torch.Tensor:
    """``out[c] = sum of vals[e]`` over column c's live edges, f32
    ``[n_cols]``: kernel B with F = 1 over the transpose."""
    ones = vals.new_ones((graph.n_rows, 1))
    return spmm_transposed(graph, vals, ones)[:, 0]


class SpmmSegmentFn(torch.autograd.Function):
    """``A @ x`` with ``A`` = ``graph``'s pattern carrying ``vals``;
    differentiable in ``vals`` and ``x``. Every graph with ``graph``'s
    edge arrays shares one cached transpose."""

    @staticmethod
    def forward(ctx, graph: SparseGraph, vals: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        # the graph keeps vals itself, so that on_transpose can tell the
        # tensor the cached transpose was built from
        graph, x = graph.with_vals(_edge_vals(vals)), x.contiguous()
        ctx.graph = graph
        # x feeds dvals alone
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None)
        return spmm_segment(graph, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        graph, g = ctx.graph, g.contiguous()
        dvals = dx = None
        if ctx.needs_input_grad[1]:
            dvals = sddmm(graph, g, x)
        if ctx.needs_input_grad[2]:
            dx = spmm_transposed(graph, graph.vals, g)
        return None, dvals, dx


class EdgeScoresFn(torch.autograd.Function):
    """``out[e] = dst[rows[e]] + src[cols[e]]`` over the ``E_pad`` edge
    slots (the rank-1 SDDMM of GAT's logits); the backward counts the
    live edges only."""

    @staticmethod
    def forward(ctx, graph: SparseGraph, dst: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
        ctx.graph = graph
        return (dst.index_select(0, graph.rows)
                + src.index_select(0, graph.cols))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = _edge_vals(g)
        d_dst = row_sums(ctx.graph, g) if ctx.needs_input_grad[1] else None
        d_src = col_sums(ctx.graph, g) if ctx.needs_input_grad[2] else None
        return None, d_dst, d_src


class SegmentSoftmaxFn(torch.autograd.Function):
    """Softmax of ``logits`` over each row's ``live`` edges, f32
    ``[E_pad]``, 0 off ``live``. ``live`` must be False on the padding
    slots. A row's max is taken with the dead slots at ``finfo(f32).min``;
    a row with no edge at all gets max 0; the denominator is clamped at
    1e-30 (sgc_tpu/models/gat.py:59-77)."""

    @staticmethod
    def forward(ctx, graph: SparseGraph, logits: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
        ctx.graph = graph
        rows = graph.rows.long()
        neg = torch.finfo(torch.float32).min
        masked = torch.where(live, logits, neg)
        seg_max = logits.new_zeros(graph.n_rows).scatter_reduce(
            0, rows, masked, "amax", include_self=False)
        ex = torch.where(live, torch.exp(logits - seg_max[rows]), 0.0)
        denom = row_sums(graph, ex)
        alpha = ex / denom[rows].clamp_min(1e-30)
        ctx.save_for_backward(alpha)
        return alpha

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (alpha,) = ctx.saved_tensors
        graph = ctx.graph
        s = row_sums(graph, alpha * g)
        d = alpha * (g - s.index_select(0, graph.rows))
        return None, d, None


class GatherRowsFn(torch.autograd.Function):
    """``table[ids]`` (any shape of ids, rows appended), differentiable in
    ``table``: the gradient of row v is the sum of the output gradient's
    rows at the positions where ``ids == v``, in increasing position
    order, by kernel B (``scatter_graph``); rows no id names get 0."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        flat = ids.reshape(-1)
        return table.index_select(0, flat).reshape(*ids.shape,
                                                   table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        rows = g.reshape(-1, g.shape[-1]).float().contiguous()
        return spmm_segment(scatter_graph(ids, ctx.n_rows), rows), None
