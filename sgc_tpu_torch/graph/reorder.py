"""Node reordering (the counterpart of sgc_tpu/graph/reorder.py).

An ordering is a permutation ``order`` with ``order[new_pos] = old id``.
Block consumers (the block-dense and hybrid splits, a row-block
partitioner) see neighbourhoods that the numbering keeps together, so the
ordering decides how many edges land in dense cells:

* :func:`lpa_order`: communities by label propagation (Raghavan et al.
  2007), laid out largest first; the main path's ordering.
* :func:`rcm_order`: reverse Cuthill-McKee (scipy), bandwidth reduction.
* :func:`bfs_order`: BFS from a min-degree seed of each component.
* :func:`degree_order`: by degree, hubs first by default.
* :func:`spectral_order`: by the Fiedler vector of each component's
  normalized Laplacian, largest component first.
* ``"none"``: the identity.

Every ordering but LPA runs the reference's scipy calls on the host, so
the permutations are the reference's bit for bit. LPA has the reference's
two label solvers, each bit for bit: ``impl="native"``, the asynchronous
sweeps of the native library (the main path's), and ``impl="sync"``, the
synchronous numpy sweeps with a seeded random tie-break. They reach
different fixpoints (a different order, split and dense fraction), so
``impl="auto"`` means native and raises when the library cannot be
built, where the reference falls back to sync with a warning.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from sgc_tpu_torch import native
from sgc_tpu_torch.graph.sparse import SparseGraph, host

LPA_MAX_ITER = 20
LPA_MIN_MOVED = 1e-3
LPA_IMPLS = ("auto", "native", "sync")


def rcm_order(adj: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation."""
    return np.asarray(
        sp.csgraph.reverse_cuthill_mckee(adj.tocsr(), symmetric_mode=True))


def bfs_order(adj: sp.spmatrix) -> np.ndarray:
    """BFS order from a min-degree seed of each connected component,
    components taken by their seeds in ascending degree (stable)."""
    csr = adj.tocsr()
    n = csr.shape[0]
    deg = np.diff(csr.indptr)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        nodes = sp.csgraph.breadth_first_order(
            csr, int(seed), directed=False, return_predecessors=False)
        order[pos:pos + len(nodes)] = nodes
        pos += len(nodes)
        visited[nodes] = True
    return order


def degree_order(adj: sp.spmatrix, descending: bool = True) -> np.ndarray:
    """Nodes by stored-entry count per row (hubs first by default)."""
    deg = np.diff(adj.tocsr().indptr)
    order = np.argsort(deg, kind="stable")
    return order[::-1].copy() if descending else order


def apply_order(adj: sp.spmatrix, order: np.ndarray,
                *aligned: np.ndarray) -> tuple:
    """Permute the adjacency's rows and columns and any per-node arrays
    (features, labels) by ``order``. Index sets (node ids) go through
    :func:`remap_indices` instead."""
    perm = np.asarray(order)
    padj = adj.tocsr()[perm][:, perm]
    return (padj, *(np.asarray(a)[perm] for a in aligned))


def remap_indices(order: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Map old node ids to their new positions under ``order``."""
    inv = np.empty(len(order), np.int64)
    inv[np.asarray(order)] = np.arange(len(order))
    return inv[np.asarray(indices)]


def spectral_order(adj: sp.spmatrix, tol: float = 1e-4) -> np.ndarray:
    """Nodes sorted by the Fiedler vector (second eigenvector of the
    normalized Laplacian), per connected component, largest component
    first. A component whose eigensolve raises is ordered by RCM instead,
    as in the reference."""
    from scipy.sparse.linalg import eigsh

    csr = adj.tocsr().astype(np.float64)
    n_comp, comp = sp.csgraph.connected_components(csr, directed=False)

    def order_component(nodes: np.ndarray) -> np.ndarray:
        m = len(nodes)
        if m <= 2:
            return nodes
        sub = csr[nodes][:, nodes]
        deg = np.asarray(sub.sum(axis=1)).ravel()
        dinv = np.where(deg > 0, deg**-0.5, 0.0)
        d = sp.diags(dinv)
        lap = sp.eye(m) - d @ sub @ d
        try:
            _, vecs = eigsh(lap, k=2, sigma=0, which="LM", tol=tol)
        except Exception:  # the reference's fallback on any solver failure
            return nodes[rcm_order(sub)]
        fiedler = dinv * vecs[:, 1]
        return nodes[np.argsort(fiedler, kind="stable")]

    if n_comp == 1:
        return order_component(np.arange(csr.shape[0]))
    parts = [np.where(comp == c)[0] for c in range(n_comp)]
    parts.sort(key=len, reverse=True)
    return np.concatenate([order_component(p) for p in parts])


def _require_native() -> None:
    if not native.available():
        raise RuntimeError(
            "the LPA ordering needs the native graph-prep library "
            "(g++ builds it at first use) and it could not be built")


def lpa_order(
    adj: sp.spmatrix,
    max_iter: int = LPA_MAX_ITER,
    seed: int = 0,
    min_moved: float = LPA_MIN_MOVED,
    impl: str = "auto",
) -> np.ndarray:
    """Community ordering of a square adjacency. Stops when at most
    ``min_moved`` of the nodes change label in a sweep, or after
    ``max_iter`` sweeps. ``impl``: ``"native"`` (or ``"auto"``) the native
    asynchronous solver, which must build; ``"sync"`` the numpy
    synchronous solver, whose ties break at random under ``seed`` (the
    native solver takes no seed)."""
    csr = adj.tocsr()
    n = csr.shape[0]
    if n == 0:
        return np.arange(0)
    if impl not in LPA_IMPLS:
        raise ValueError(f"unknown lpa impl {impl!r}")
    if impl == "sync":
        labels = _lpa_labels_sync(csr, max_iter, seed, min_moved)
    else:
        _require_native()
        labels, _ = native.lpa_labels(csr.indptr, csr.indices,
                                      max_iter=max_iter,
                                      min_moved_frac=min_moved)
    return _canonical_order_from_labels(labels, n)


def _lpa_labels_sync(csr, max_iter: int, seed: int,
                     min_moved: float) -> np.ndarray:
    """Synchronous LPA sweeps in numpy: each sweep counts every (row,
    neighbour label) pair by sort + unique and gives each row its most
    frequent label, ties broken uniformly at random (a fresh draw each
    sweep from ``default_rng(seed)``)."""
    n = csr.shape[0]
    indices = csr.indices.astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
    labels = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    for _ in range(max_iter):
        key = rows * n + labels[indices]
        uniq, counts = np.unique(key, return_counts=True)
        urow = uniq // n
        ulab = uniq % n
        # the last entry of each row's group, sorted by (row, count,
        # random), is a most frequent label
        perm = np.lexsort((rng.random(len(uniq)), counts, urow))
        urow_s = urow[perm]
        last = np.nonzero(np.diff(urow_s, append=n + 1))[0]
        new = labels.copy()
        new[urow_s[last]] = ulab[perm][last]
        moved = int((new != labels).sum())
        labels = new
        if moved <= min_moved * n:
            break
    return labels


def _canonical_order_from_labels(labels: np.ndarray, n: int) -> np.ndarray:
    """Community labels -> node order: largest community first, ascending
    old id within."""
    comm_ids, comm_inverse, comm_sizes = np.unique(
        labels, return_inverse=True, return_counts=True)
    rank = np.empty(len(comm_ids), np.int64)
    rank[np.argsort(-comm_sizes, kind="stable")] = np.arange(len(comm_ids))
    return np.lexsort((np.arange(n), rank[comm_inverse]))


ORDERINGS = {
    "rcm": rcm_order,
    "bfs": bfs_order,
    "degree": degree_order,
    "spectral": spectral_order,
    "lpa": lpa_order,
    "none": lambda adj: np.arange(adj.shape[0]),
}


def fetch_ordering(name: str):
    if name not in ORDERINGS:
        raise ValueError(f"unknown ordering {name!r}; one of {list(ORDERINGS)}")
    return ORDERINGS[name]


def reorder_graph_arrays(graph: SparseGraph, name: str, features, labels,
                         idx):
    """Reorder a host graph and its node-aligned arrays by the ordering
    ``name``. Returns ``(graph_p, features_p, labels_p, idx_p, order)``
    with ``graph_p`` on the host and ``idx_p`` sorted.

    ``"lpa"`` takes the reference's scipy-free path: coalesce the (row,
    col)-sorted edges (duplicates sum), run the native LPA on their CSR,
    permute the COO directly and rebuild with the native sort. Every
    other name takes the reference's scipy path (:func:`reorder_scipy`).
    """
    fetch_ordering(name)
    if name != "lpa":
        return reorder_scipy(graph, name, features, labels, idx)
    if graph.n_rows != graph.n_cols:
        raise ValueError("the LPA ordering needs a square graph")
    _require_native()
    rows, cols, vals = _live_edges(graph)
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


def reorder_scipy(graph: SparseGraph, name: str, features, labels, idx):
    """The reference's shared recipe on the host: coo -> csr (duplicates
    sum) -> ordering -> :func:`apply_order` -> sorted indices ->
    ``SparseGraph.from_scipy``. Same returns as
    :func:`reorder_graph_arrays`."""
    rows, cols, vals = _live_edges(graph)
    adj = sp.coo_matrix((vals, (rows, cols)),
                        shape=(graph.n_rows, graph.n_cols)).tocsr()
    order = fetch_ordering(name)(adj)
    adj_p, features_p, labels_p = apply_order(
        adj, order, np.asarray(features), np.asarray(labels))
    idx_p = np.sort(remap_indices(order, np.asarray(idx)))
    adj_p.sort_indices()  # from_scipy's presorted path
    return (SparseGraph.from_scipy(adj_p), features_p, labels_p, idx_p,
            order)


def _live_edges(graph: SparseGraph):
    nnz = graph.nnz
    return (host(graph.rows)[:nnz].astype(np.int64),
            host(graph.cols)[:nnz].astype(np.int64),
            host(graph.vals)[:nnz].astype(np.float32))
