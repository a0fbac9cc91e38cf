"""Hybrid SpMM: dense cells through kernel C, the sparse remainder through
kernel B (the counterpart of sgc_tpu/ops/spmm_hybrid.py).

Edges are split once, on the host, by cell fill under a (row_block,
stripe) tiling: a cell whose edges fill at least ``min_fill`` of its
padded chunks goes to the tiled layout (ops/spmm_tiled.py), every other
edge stays in a sparse remainder. The split is bit for bit the
reference's. On the card :func:`spmm_hybrid_split` runs kernel C on the
dense part and then kernel B on the remainder with the dense part added
in kernel B's epilogue (``spmm_segment(rest, x, dense)``): the
reference's ``dense + rest`` with no extra pass. On the CPU the same
calls run their plain versions. ``precision`` (default ``"f32"``) is the
dense part's, as in the reference: at ``"bf16"`` kernel C rounds x and
each slot's product to bf16; the remainder stays f32.

The admission constants below were measured by the reference on a TPU
v5e and describe its one-hot MXU kernel and its XLA gather; they say
nothing about the H100, and kernel C performs no one-hot matmul. The
reference never calibrates this admission (locality.py:172-201), and
the port keeps that behaviour, so both split alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops.spmm import check_precision, spmm_segment
from sgc_tpu_torch.ops.spmm_tiled import (
    TiledArgs,
    TiledGraph,
    row_csr,
    spmm_tiled_flat,
    tile_graph,
    tiled_device_args,
)
from sgc_tpu_torch.utils.buildcache import placed

# TPU-measured admission constants (see the module docstring)
MXU_SUSTAINED_FLOPS = 142e12
XLA_EDGES_PER_S = 34e6

DEFAULT_ROW_BLOCK = 512
DEFAULT_STRIPE = 512
DEFAULT_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class HybridSplit:
    """Host-side split of a graph into tiled dense cells + remainder.

    ``tiled`` is None when no cell met the fill threshold, ``rest`` is
    None when every edge landed in a dense cell. ``csr`` is kernel C's
    operand, ``tiled``'s edges re-sorted by row (``spmm_tiled.row_csr``),
    built with the split so that it counts in the plan's prep time.
    """

    tiled: TiledGraph | None
    rest: SparseGraph | None
    n_rows: int
    n_cols: int
    dense_edges: int
    sparse_edges: int
    pad: float                  # slots / dense edges (1.0 if none)
    min_fill: float
    csr: tuple | None = None    # (row_ptr, cols, vals) of tiled


def min_fill_for(row_block: int, stripe: int, n_features: int,
                 xla_edges_per_s: float = XLA_EDGES_PER_S,
                 mxu_flops_per_s: float = MXU_SUSTAINED_FLOPS) -> float:
    """Cell fill at which the reference's one-hot kernel matches its XLA
    gather: per padded edge the one-hot form costs 2 * (W + R) * F_pad
    flops."""
    f_pad = -(-max(n_features, 128) // 128) * 128
    full_fill_rate = mxu_flops_per_s / (2.0 * (stripe + row_block) * f_pad)
    return min(1.0, xla_edges_per_s / full_fill_rate)


def split_dense_cells(graph: SparseGraph, n_features: int,
                      row_block: int = DEFAULT_ROW_BLOCK,
                      stripe: int = DEFAULT_STRIPE,
                      chunk: int = DEFAULT_CHUNK,
                      min_fill: float | None = None) -> HybridSplit:
    """Partition edges by cell fill (host-side, once per graph)."""
    if min_fill is None:
        min_fill = min_fill_for(row_block, stripe, n_features)
    rows = host(graph.rows)[: graph.nnz].astype(np.int64)
    cols = host(graph.cols)[: graph.nnz].astype(np.int64)
    vals = host(graph.vals)[: graph.nnz].astype(np.float32)

    n_st = -(-graph.n_cols // stripe)
    cell = (rows // row_block) * n_st + (cols // stripe)
    counts = np.bincount(cell,
                         minlength=(-(-graph.n_rows // row_block)) * n_st)
    with np.errstate(divide="ignore", invalid="ignore"):
        fill = counts / (-(-counts // chunk) * chunk).clip(min=1)
    dense_mask = (fill >= min_fill)[cell]
    n_dense = int(dense_mask.sum())
    n_sparse = len(rows) - n_dense

    tiled = csr = None
    pad = 1.0
    if n_dense:
        dense_graph = SparseGraph.from_coo(
            rows[dense_mask], cols[dense_mask], vals[dense_mask],
            n_rows=graph.n_rows, n_cols=graph.n_cols, presorted=True)
        tiled = tile_graph(dense_graph, row_block, stripe, chunk)
        csr = row_csr(tiled)
        pad = tiled.rows.shape[0] / n_dense
    rest = None
    if n_sparse:
        rest = SparseGraph.from_coo(
            rows[~dense_mask], cols[~dense_mask], vals[~dense_mask],
            n_rows=graph.n_rows, n_cols=graph.n_cols, presorted=True)
    return HybridSplit(
        tiled=tiled, rest=rest, n_rows=graph.n_rows, n_cols=graph.n_cols,
        dense_edges=n_dense, sparse_edges=n_sparse, pad=pad,
        min_fill=min_fill, csr=csr)


@dataclasses.dataclass(frozen=True)
class HybridArgs:
    """A split's arrays placed on one device (once per plan)."""

    tiled: TiledArgs | None
    rest: SparseGraph | None

    @property
    def device(self) -> torch.device | None:
        if self.tiled is not None:
            return self.tiled.device
        return self.rest.device if self.rest is not None else None


def hybrid_device_args(split: HybridSplit, device) -> HybridArgs:
    """Place ``split`` on ``device`` (an explicit device, no default)."""
    dev = torch.device(device)
    return HybridArgs(
        tiled=(tiled_device_args(split.tiled, dev, split.csr)
               if split.tiled is not None else None),
        rest=split.rest.to(dev) if split.rest is not None else None)


def spmm_hybrid_split(split: HybridSplit, x: torch.Tensor,
                      args: HybridArgs | None = None,
                      precision: str = "f32") -> torch.Tensor:
    """``S @ x`` over a prebuilt split, f32 ``[n_rows, F]``: kernel C on
    the dense part, then kernel B on the remainder adding the dense part
    (plain versions on a CPU tensor). Deterministic, and equal to the
    all-segment product to f32 rounding (the dense part sums cell-major)."""
    if args is None:
        args = hybrid_device_args(split, x.device)
    if split.tiled is not None and args.tiled is None:
        raise ValueError("split has a dense part but args carry none")
    if split.rest is not None and args.rest is None:
        raise ValueError("split has a sparse remainder but args carry none")
    if args.device is not None and args.device != x.device:
        raise ValueError(f"args on {args.device}, x on {x.device}")
    check_precision(precision)
    dense = (spmm_tiled_flat(split.tiled, x, args.tiled, precision)
             if split.tiled is not None else None)
    if args.rest is not None:
        return spmm_segment(args.rest, x, dense)
    if dense is not None:
        return dense
    return x.new_zeros((split.n_rows, x.shape[1]))


def _split_cached(graph: SparseGraph, n_features: int, row_block: int,
                  stripe: int, chunk: int, min_fill: float | None,
                  device) -> tuple[HybridSplit, HybridArgs]:
    """The split of ``graph`` and its placement on ``device``, built on
    first use (``utils.buildcache.placed``): the split is O(E) host work
    and placing it uploads every edge, and a K-hop loop must do neither
    per hop."""
    return placed(
        graph, ("hybrid", n_features, row_block, stripe, chunk, min_fill),
        device,
        lambda: split_dense_cells(graph, n_features, row_block, stripe,
                                  chunk, min_fill),
        hybrid_device_args)


def spmm_hybrid(graph: SparseGraph, x: torch.Tensor,
                row_block: int = DEFAULT_ROW_BLOCK,
                stripe: int = DEFAULT_STRIPE, chunk: int = DEFAULT_CHUNK,
                min_fill: float | None = None,
                precision: str = "f32") -> torch.Tensor:
    """Drop-in hybrid SpMM: split and place on x's device on first use
    (cached), then run."""
    split, args = _split_cached(graph, int(x.shape[1]), row_block, stripe,
                                chunk, min_fill, x.device)
    return spmm_hybrid_split(split, x, args, precision)
