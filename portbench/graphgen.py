"""The benchmark's graph generator: a frozen numpy copy of the port's
synthetic Reddit-shape draw (``sgc_tpu_torch/data/synthetic.py``,
``clustered_edges`` and ``synthetic_reddit_clustered`` with its ids
shuffled) and of the augmented normalization ``D^-1/2 (A + I) D^-1/2``.

It lives here so that one seed gives one graph whatever later changes do
to the program. Every random stream is the original's, draw for draw:
the main ``default_rng(seed)`` stream, the planted-label stream
``default_rng(seed + 1_000_003)`` and the dummy label draw that keeps the
shuffle permutation where it was.

A traffic file's ``graph`` object names the draw (``kind``) and gives
its parameters; the configuration gives the sizes (``nodes``, ``edges``,
``features``, ``classes``, ``train``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class GraphData:
    """One generated graph, on the host.

    ``src -> dst`` is the directed half of the edge draws (duplicates
    kept); the operator is ``S = D^-1/2 (A + I) D^-1/2`` of ``A = B +
    B^T``, ``B`` the draws' count matrix. ``features`` f32 ``[n, F]``,
    ``labels`` int32 ``[n]``, ``idx_train`` sorted int64.
    """

    src: np.ndarray
    dst: np.ndarray
    features: np.ndarray
    labels: np.ndarray
    idx_train: np.ndarray
    n: int
    n_classes: int


def _sizes(shape: dict, scale: float) -> tuple[int, int, int]:
    n = max(int(shape["nodes"] * scale), 1024)
    e = max(int(shape["edges"] * scale), 4096)
    n_train = min(max(int(shape["train"] * scale), 256), n)
    return n, e, n_train


def clustered(shape: dict, seed: int, scale: float = 1.0,
              communities: int = 50, intra: float = 0.85) -> GraphData:
    """``communities`` equal communities holding ``intra`` of the edges
    (hub-skewed: squared-uniform sources), the rest uniform pairs; labels
    planted (community % classes, 10% noise) with a class-mean feature
    offset; the node ids permuted."""
    n, e, n_train = _sizes(shape, scale)
    n_feat, n_cls = int(shape["features"]), int(shape["classes"])
    rng = np.random.default_rng(seed)

    m = e // 2
    comm_size = max(n // communities, 1)
    is_intra = rng.random(m) < intra
    n_in = int(is_intra.sum())

    comm = rng.integers(0, communities, n_in)
    base = comm * comm_size
    src_in = base + ((rng.random(n_in) ** 2 * comm_size)
                     .astype(np.int64) % comm_size)
    dst_in = base + rng.integers(0, comm_size, n_in)
    src_out = rng.integers(0, n, m - n_in)
    dst_out = rng.integers(0, n, m - n_in)

    src = np.clip(np.concatenate([src_in, src_out]), 0, n - 1)
    dst = np.clip(np.concatenate([dst_in, dst_out]), 0, n - 1)

    features = rng.normal(size=(n, n_feat)).astype(np.float32)
    rng_y = np.random.default_rng(seed + 1_000_003)
    _ = rng.integers(0, n_cls, n)
    comm_of = np.minimum(np.arange(n) // comm_size, communities - 1)
    labels = (comm_of % n_cls).astype(np.int32)
    flip = rng_y.random(n) < 0.1
    labels[flip] = rng_y.integers(0, n_cls, int(flip.sum())).astype(np.int32)
    class_means = (0.3 * rng_y.normal(size=(n_cls, n_feat))).astype(
        np.float32)
    features += class_means[labels]

    perm = rng.permutation(n)  # perm[old] = new id
    src, dst = perm[src], perm[dst]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    idx_train = np.sort(perm[np.arange(n_train)])
    return GraphData(src, dst, features[inv], labels[inv], idx_train, n,
                     n_cls)


KINDS = {"clustered": clustered}


def generate(shape: dict, graph: dict, seed: int) -> GraphData:
    """The draw named by ``graph["kind"]``, its other keys as
    parameters, at the configuration's ``shape``."""
    params = {k: v for k, v in graph.items() if k != "kind"}
    return KINDS[graph["kind"]](shape, seed, **params)


def normalized(data: GraphData) -> sp.csr_matrix:
    """``D^-1/2 (A + I) D^-1/2`` as the port's loaders build it (scipy,
    degrees in float64), CSR with sorted indices, values float32."""
    n = data.n
    adj = sp.coo_matrix((np.ones(len(data.src), dtype=np.float32),
                         (data.src, data.dst)), shape=(n, n))
    adj = sp.coo_matrix(adj + adj.T + sp.eye(n))
    row_sum = np.asarray(adj.sum(1)).ravel()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(row_sum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    out = (d @ adj @ d).tocsr().astype(np.float32)
    out.sort_indices()
    return out
