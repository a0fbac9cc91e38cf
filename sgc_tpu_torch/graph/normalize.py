"""Adjacency and feature normalization (the counterpart of
sgc_tpu/graph/normalize.py).

Two tiers, as in the reference:

* **Host tier** (numpy/scipy, bit for bit the reference's): the registry
  of adjacency transforms (``AugNormAdj``, ``TextAugNormAdj``,
  ``RWalkAdj``, ``NormAdj``, ``NoNorm``, plus :func:`register_normalization`),
  :func:`row_normalize` (scipy sparse or dense) and :func:`symmetrize_max`.
* **Device tier** (torch tensors): :func:`normalize_adjacency_device`
  re-weights a placed :class:`SparseGraph` as ``D^-1/2 A D^-1/2``, its
  degrees summed in a fixed order (kernel B on the card, the sequential
  plain version on the CPU); :func:`standardize_features` is the Reddit
  feature standardization with the unbiased (correction 1) std.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph

# --------------------------------------------------------------------- host


def aug_normalized_adjacency(adj: sp.spmatrix) -> sp.coo_matrix:
    """S = (D+I)^-1/2 (A+I) (D+I)^-1/2 ("AugNormAdj")."""
    adj = sp.coo_matrix(adj + sp.eye(adj.shape[0]))
    row_sum = np.asarray(adj.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(row_sum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    return (d @ adj @ d).tocoo()


def sym_normalized_adjacency_selfloops(adj: sp.spmatrix) -> sp.coo_matrix:
    """The TextSGC pipeline's name for :func:`aug_normalized_adjacency`
    ("TextAugNormAdj"): the same operator on symmetric inputs."""
    return aug_normalized_adjacency(adj)


def no_norm(adj: sp.spmatrix) -> sp.coo_matrix:
    """Identity transform: the raw A, no self-loops ("NoNorm")."""
    return sp.coo_matrix(adj)


def rw_normalized_adjacency(adj: sp.spmatrix) -> sp.coo_matrix:
    """S = (D+I)^-1 (A+I), the row-stochastic random walk ("RWalkAdj")."""
    adj = sp.coo_matrix(adj + sp.eye(adj.shape[0]))
    row_sum = np.asarray(adj.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        d_inv = np.power(row_sum, -1.0)
    d_inv[np.isinf(d_inv)] = 0.0
    return (sp.diags(d_inv) @ adj).tocoo()


def sym_normalized_adjacency(adj: sp.spmatrix) -> sp.coo_matrix:
    """S = D^-1/2 A D^-1/2 without self-loops ("NormAdj")."""
    adj = sp.coo_matrix(adj)
    row_sum = np.asarray(adj.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(row_sum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    return (d @ adj @ d).tocoo()


_NORMALIZATIONS = {
    "AugNormAdj": aug_normalized_adjacency,
    "TextAugNormAdj": sym_normalized_adjacency_selfloops,
    "RWalkAdj": rw_normalized_adjacency,
    "NormAdj": sym_normalized_adjacency,
    "NoNorm": no_norm,
}


def fetch_normalization(name: str):
    """Registry lookup by the reference's names."""
    try:
        return _NORMALIZATIONS[name]
    except KeyError:
        raise ValueError(
            f"Invalid normalization {name!r}; known: {sorted(_NORMALIZATIONS)}"
        ) from None


def register_normalization(name: str, fn) -> None:
    """Add (or replace) a transform under ``name``."""
    _NORMALIZATIONS[name] = fn


def row_normalize(mx):
    """Row-normalize a scipy sparse matrix or a dense array (f32); rows
    that sum to 0 stay 0."""
    if sp.issparse(mx):
        rowsum = np.asarray(mx.sum(1)).ravel()
        with np.errstate(divide="ignore"):
            r_inv = np.power(rowsum, -1.0)
        r_inv[np.isinf(r_inv)] = 0.0
        return sp.diags(r_inv) @ mx
    mx = np.asarray(mx, dtype=np.float32)
    rowsum = mx.sum(1)
    with np.errstate(divide="ignore"):
        r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return mx * r_inv[:, None]


def symmetrize_max(adj: sp.spmatrix) -> sp.coo_matrix:
    """Elementwise max(A, A^T), the citation graphs' symmetrization."""
    adj = adj.tocsr()
    t = adj.T.tocsr()
    return (adj + t.multiply(t > adj) - adj.multiply(t > adj)).tocoo()


# ------------------------------------------------------------------- device


def normalize_adjacency_device(graph: SparseGraph) -> SparseGraph:
    """``D^-1/2 A D^-1/2`` re-weighting of a graph placed on a device
    (:meth:`SparseGraph.to`); the result stays on that device.

    The degrees are the row sums of the values, ``A @ 1``, through
    ``spmm_segment`` (kernel B on the card), so every row sums in its
    sorted edge order and repeated runs give the same bits. Self-loops
    must already be in the pattern; padding edges stay exactly 0.
    """
    from sgc_tpu_torch.ops.spmm import spmm_segment

    if graph.device is None:
        raise ValueError("place the graph on a device first (graph.to)")
    ones = torch.ones((graph.n_cols, 1), dtype=torch.float32,
                      device=graph.device)
    deg = spmm_segment(graph, ones)[:, 0]
    d_inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg),
                             torch.zeros_like(deg))
    rows, cols = graph.rows.long(), graph.cols.long()
    return graph.with_vals(d_inv_sqrt[rows] * graph.vals * d_inv_sqrt[cols])


def standardize_features(x: torch.Tensor) -> torch.Tensor:
    """Zero mean and unit std per feature column, the std unbiased
    (correction 1), as the reference's ``ddof=1``."""
    mean = x.mean(dim=0, keepdim=True)
    std = x.std(dim=0, keepdim=True)
    return (x - mean) / std
