"""Node reordering by label propagation (the LPA path of
sgc_tpu/graph/reorder.py).

Label propagation (Raghavan et al. 2007) finds the communities of a
clustered graph; laying nodes out community by community (largest first,
ascending old id inside) puts most edges into dense diagonal cells of a
(row_block, stripe) tiling, which is what the block-dense SpMM feeds on.

Only the native asynchronous solver is ported, and it is required: the
reference's synchronous numpy solver reaches a different fixpoint (a
different order, split and dense fraction), so the port raises instead of
falling back to it. The rcm, bfs, degree and spectral orderings wait for
a later slice of the port.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from sgc_tpu_torch import native
from sgc_tpu_torch.graph.sparse import SparseGraph, host

LPA_MAX_ITER = 20
LPA_MIN_MOVED = 1e-3


def _require_native() -> None:
    if not native.available():
        raise RuntimeError(
            "the LPA ordering needs the native graph-prep library "
            "(g++ builds it at first use) and it could not be built")


def lpa_order(
    adj: sp.spmatrix,
    max_iter: int = LPA_MAX_ITER,
    min_moved: float = LPA_MIN_MOVED,
) -> np.ndarray:
    """Community ordering (``order[new_pos] = old id``) of a square
    adjacency. Stops when at most ``min_moved`` of the nodes change label
    in a sweep, or after ``max_iter`` sweeps."""
    csr = adj.tocsr()
    n = csr.shape[0]
    if n == 0:
        return np.arange(0)
    _require_native()
    labels, _ = native.lpa_labels(csr.indptr, csr.indices,
                                  max_iter=max_iter, min_moved_frac=min_moved)
    return _canonical_order_from_labels(labels, n)


def _canonical_order_from_labels(labels: np.ndarray, n: int) -> np.ndarray:
    """Community labels -> node order: largest community first, ascending
    old id within."""
    comm_ids, comm_inverse, comm_sizes = np.unique(
        labels, return_inverse=True, return_counts=True)
    rank = np.empty(len(comm_ids), np.int64)
    rank[np.argsort(-comm_sizes, kind="stable")] = np.arange(len(comm_ids))
    return np.lexsort((np.arange(n), rank[comm_inverse]))


def reorder_graph_arrays(graph: SparseGraph, name: str, features, labels,
                         idx):
    """Reorder a square host graph and its node-aligned arrays.

    The reference's scipy-free LPA path: coalesce the (row, col)-sorted
    edges (duplicates sum), run the native LPA on their CSR, permute the
    COO directly and rebuild with the native sort. Returns ``(graph_p,
    features_p, labels_p, idx_p, order)`` with ``graph_p`` on the host and
    ``idx_p`` sorted.
    """
    if name != "lpa":
        raise NotImplementedError(
            f"ordering {name!r} is not ported yet (only 'lpa')")
    if graph.n_rows != graph.n_cols:
        raise ValueError("the LPA ordering needs a square graph")
    _require_native()
    nnz = graph.nnz
    rows = host(graph.rows)[:nnz].astype(np.int64)
    cols = host(graph.cols)[:nnz].astype(np.int64)
    vals = host(graph.vals)[:nnz].astype(np.float32)

    rows, cols, vals = native.coalesce(rows, cols, vals)
    indptr = native.row_ptr_from_sorted(rows, graph.n_rows)
    lab, _ = native.lpa_labels(indptr, cols, max_iter=LPA_MAX_ITER,
                               min_moved_frac=LPA_MIN_MOVED)
    order = _canonical_order_from_labels(lab, graph.n_rows)
    inv = np.empty(graph.n_rows, np.int64)
    inv[order] = np.arange(graph.n_rows)
    graph_p = SparseGraph.from_coo(inv[rows], inv[cols], vals,
                                   n_rows=graph.n_rows, n_cols=graph.n_cols)
    features_p = np.take(np.asarray(features), order, axis=0)
    labels_p = np.asarray(labels)[order]
    idx_p = np.sort(inv[np.asarray(idx)])
    return graph_p, features_p, labels_p, idx_p, order
