"""Synthetic Reddit-shaped graphs (the counterpart of
sgc_tpu/data/synthetic.py).

Pure numpy, and every random stream is the reference's, draw for draw:
the main ``default_rng(seed)`` stream, the separate planted-label stream
``default_rng(seed + 1_000_003)`` and the dummy label draw that keeps the
shuffle permutation where it was. The same seed therefore gives the same
arrays, bit for bit, in both packages. Graphs come back host-resident
(numpy); :meth:`SparseGraph.to` places them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
from sgc_tpu_torch.graph.sparse import SparseGraph

REDDIT_NODES = 232_965
REDDIT_EDGES = 11_606_919
REDDIT_FEATURES = 602
REDDIT_CLASSES = 41
REDDIT_TRAIN = 152_410


def synthetic_reddit(scale: float, seed: int = 42):
    """(graph, features, labels, idx_train) at ``scale`` of Reddit with a
    uniform column spread and squared-uniform row skew."""
    n = max(int(REDDIT_NODES * scale), 1024)
    e = max(int(REDDIT_EDGES * scale), 4096)
    rng = np.random.default_rng(seed)

    src = (rng.random(e // 2) ** 2 * n).astype(np.int64) % n
    dst = rng.integers(0, n, e // 2)
    adj = sp.coo_matrix(
        (np.ones(e // 2, dtype=np.float32), (src, dst)), shape=(n, n))
    adj = adj + adj.T
    graph = SparseGraph.from_scipy(aug_normalized_adjacency(adj))

    features = rng.normal(size=(n, REDDIT_FEATURES)).astype(np.float32)
    labels = rng.integers(0, REDDIT_CLASSES, n).astype(np.int32)
    n_train = min(max(int(REDDIT_TRAIN * scale), 256), n)
    return graph, features, labels, np.arange(n_train)


def clustered_edges(
    scale: float,
    seed: int = 42,
    communities: int = 50,
    intra: float = 0.85,
    shuffle: bool = False,
    tail: str = "sq",
):
    """The raw draw of :func:`synthetic_reddit_clustered`: ``(src, dst,
    features, labels, idx_train, n)``, ``src -> dst`` the directed half
    of the edges (one entry per draw, duplicates kept), before
    symmetrization and normalization."""
    if tail not in ("sq", "powerlaw"):
        raise ValueError(f"unknown tail {tail!r}")
    n = max(int(REDDIT_NODES * scale), 1024)
    e = max(int(REDDIT_EDGES * scale), 4096)
    rng = np.random.default_rng(seed)

    m = e // 2
    comm_size = max(n // communities, 1)
    is_intra = rng.random(m) < intra
    n_in = int(is_intra.sum())

    comm = rng.integers(0, communities, n_in)
    base = comm * comm_size
    if tail == "powerlaw":
        hub = np.minimum(rng.zipf(1.5, n_in) - 1, comm_size - 1)
        src_in = base + hub
    else:
        src_in = base + ((rng.random(n_in) ** 2 * comm_size)
                         .astype(np.int64) % comm_size)
    dst_in = base + rng.integers(0, comm_size, n_in)
    src_out = rng.integers(0, n, m - n_in)
    dst_out = rng.integers(0, n, m - n_in)

    src = np.clip(np.concatenate([src_in, src_out]), 0, n - 1)
    dst = np.clip(np.concatenate([dst_in, dst_out]), 0, n - 1)

    features = rng.normal(size=(n, REDDIT_FEATURES)).astype(np.float32)
    # planted labels come from their own stream; the main stream still
    # makes its old label draw so the shuffle permutation below is the
    # reference's
    rng_y = np.random.default_rng(seed + 1_000_003)
    _ = rng.integers(0, REDDIT_CLASSES, n)
    comm_of = np.minimum(np.arange(n) // comm_size, communities - 1)
    labels = (comm_of % REDDIT_CLASSES).astype(np.int32)
    flip = rng_y.random(n) < 0.1
    labels[flip] = rng_y.integers(
        0, REDDIT_CLASSES, int(flip.sum())).astype(np.int32)
    class_means = (0.3 * rng_y.normal(
        size=(REDDIT_CLASSES, REDDIT_FEATURES))).astype(np.float32)
    features += class_means[labels]
    n_train = min(max(int(REDDIT_TRAIN * scale), 256), n)
    idx_train = np.arange(n_train)

    if shuffle:
        perm = rng.permutation(n)  # perm[old] = new id
        src, dst = perm[src], perm[dst]
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        features = features[inv]
        labels = labels[inv]
        idx_train = np.sort(perm[idx_train])
    return src, dst, features, labels, idx_train, n


def synthetic_reddit_clustered(
    scale: float,
    seed: int = 42,
    communities: int = 50,
    intra: float = 0.85,
    shuffle: bool = False,
    tail: str = "sq",
):
    """Reddit-shaped graph with ``communities`` equal-size communities:
    ``intra`` of the edges fall inside a community (hub-skewed by
    ``tail``: "sq" or "powerlaw"), the rest are uniform pairs. Labels are
    planted (community % 41, 10% noise) with a class-mean feature offset,
    so a trained head lands far above chance. ``shuffle=True`` permutes
    the node ids so a reordering has to discover the communities.

    Returns ``(graph, features, labels, idx_train)``, all on the host.
    """
    src, dst, features, labels, idx_train, n = clustered_edges(
        scale, seed, communities, intra, shuffle, tail)
    adj = sp.coo_matrix(
        (np.ones(len(src), dtype=np.float32), (src, dst)), shape=(n, n))
    adj = adj + adj.T
    graph = SparseGraph.from_scipy(aug_normalized_adjacency(adj))
    return graph, features, labels, idx_train
