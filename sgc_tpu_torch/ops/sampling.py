"""Neighborhood-sampled inductive inference (the counterpart of
sgc_tpu/ops/sampling.py): estimate ``(S^K x)[nodes]`` for a batch of
target nodes from a fixed-fanout sampled K-hop tree instead of a
full-graph SpMM per request.

Each hop samples ``fanout`` neighbors of every frontier node uniformly
with replacement from its CSR row and weights neighbor ``j`` of ``v`` by
``S[v, j] * deg(v)``, so ``mean_k w_k x[j_k]`` is unbiased for
``(S x)[v]``. A node with no edges samples itself with weight 0.

The random draw is kept apart from the deterministic work, so that a
test can give both packages the same offsets:

* :func:`draw_offsets`: offsets in ``[0, max(d, 1))`` per row, from an
  explicit ``torch.Generator`` on the graph's device;
* :func:`gather_neighbors`: ``(nbr, w)`` from given offsets
  (sampling.py:67-80);
* :func:`reduce_tree`: the weighted means of a given sampled tree, leaf
  to root (sampling.py:96-113).

:func:`sample_neighbors`, :func:`sample_tree` and
:func:`sampled_propagate` compose them with the reference's signatures,
a generator in place of the key. On the card everything is plain
PyTorch: the leaf gather holds ``B * prod(fanouts)`` feature rows
(256,000 x 602 f32, 616 MB, at batch 1024 with fanouts (25, 10)).
"""

from __future__ import annotations

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph

# draws are taken from [0, 2**62) and reduced mod the degree: exact in
# integers for every degree, with a bias below d / 2**62
_DRAW_RANGE = 1 << 62


def neighbor_table(graph: SparseGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """``(starts, degrees)``, int32[n_rows] views of the CSR row pointer
    (sampling.py:40-48)."""
    row_ptr = graph.row_ptr
    return row_ptr[:-1], row_ptr[1:] - row_ptr[:-1]


def draw_offsets(degrees: torch.Tensor, fanout: int,
                 generator: torch.Generator) -> torch.Tensor:
    """int64[B, fanout] offsets, uniform in ``[0, max(d, 1))`` for each
    row's degree ``d`` (``jax.random.randint``'s per-row bound, sampling.py:
    67). Computed in integers: a float ``floor(u * d)`` in f32 can round
    up to ``d`` at large degrees."""
    d = torch.clamp(degrees.long(), min=1)[:, None]
    r = torch.randint(0, _DRAW_RANGE, (degrees.shape[0], fanout),
                      generator=generator, device=degrees.device,
                      dtype=torch.int64)
    return torch.remainder(r, d)


def gather_neighbors(graph: SparseGraph, nodes: torch.Tensor,
                     offs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(nbr int32[B, f], w float32[B, f])`` for the sampled offsets:
    ``nbr = cols[start + off]``, ``w = vals[start + off] * deg``; an
    isolated node gives itself with weight 0.

    An isolated row's start may be ``nnz``, one past the edge arrays when
    ``nnz`` is a multiple of the padding. The index is masked before the
    gather (the reference lets XLA clamp it and discards the value after):
    on CUDA an out-of-range gather is a device-side assert that ends the
    process."""
    starts, degrees = neighbor_table(graph)
    nodes = nodes.long()
    s = starts[nodes].long()
    d = degrees[nodes]
    isolated = (d == 0)[:, None]
    edge_idx = torch.where(isolated, torch.zeros_like(offs),
                           s[:, None] + offs)
    nbr = graph.cols[edge_idx]
    w = graph.vals[edge_idx] * d[:, None].to(torch.float32)
    nbr = torch.where(isolated, nodes[:, None].to(nbr.dtype), nbr)
    w = torch.where(isolated, torch.zeros_like(w), w)
    return nbr, w


def sample_neighbors(graph: SparseGraph, nodes: torch.Tensor,
                     generator: torch.Generator, fanout: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform-with-replacement neighbor sample per node (sampling.py:
    52-81): ``(nbr int32[B, fanout], w float32[B, fanout])``."""
    _, degrees = neighbor_table(graph)
    offs = draw_offsets(degrees[nodes.long()], fanout, generator)
    return gather_neighbors(graph, nodes, offs)


def sample_tree(graph: SparseGraph, nodes: torch.Tensor,
                generator: torch.Generator, fanouts: tuple[int, ...]):
    """The sampled computation tree, root to leaf: ``(frontiers,
    weights)``, ``frontiers[t]`` the B * prod(fanouts[:t]) node ids at
    depth t (``frontiers[0] = nodes``) and ``weights[t]`` their
    ``[-1, fanouts[t]]`` importance weights (sampling.py:99-106)."""
    frontiers, weights = [nodes], []
    for f in fanouts:
        nbr, w = sample_neighbors(graph, frontiers[-1].reshape(-1),
                                  generator, f)
        frontiers.append(nbr.reshape(-1))
        weights.append(w.reshape(-1, f))
    return frontiers, weights


def reduce_tree(features: torch.Tensor, frontiers, weights,
                fanouts: tuple[int, ...]) -> torch.Tensor:
    """Collapse a sampled tree: gather the leaves' features once, then
    ``x_t = mean_f w_t * x_{t+1}`` depth by depth (sampling.py:108-113).
    Returns f32 ``[B, F]``."""
    x = features[frontiers[-1].long()]
    for t in range(len(fanouts) - 1, -1, -1):
        f = fanouts[t]
        x = x.reshape(-1, f, x.shape[-1])
        x = torch.mean(weights[t][..., None] * x, dim=1)
    return x


def sampled_propagate(graph: SparseGraph, features: torch.Tensor,
                      nodes: torch.Tensor, generator: torch.Generator,
                      fanouts: tuple[int, ...]) -> torch.Tensor:
    """Monte-Carlo estimate of ``(S^K x)[nodes]`` (sampling.py:84-114);
    ``graph``, ``features``, ``nodes`` and the generator on one device."""
    frontiers, weights = sample_tree(graph, nodes, generator, fanouts)
    return reduce_tree(features, frontiers, weights, fanouts)


def sampled_sgc_infer(model, graph: SparseGraph, features: torch.Tensor,
                      nodes, generator: torch.Generator,
                      fanouts: tuple[int, ...] = (25, 10)) -> torch.Tensor:
    """SGC logits for a node batch from sampled neighborhoods."""
    from sgc_tpu_torch.models.sgc import sgc_apply

    nodes = torch.as_tensor(nodes, device=features.device)
    return sgc_apply(model, sampled_propagate(graph, features, nodes,
                                              generator, fanouts))


def sampled_propagate_host(graph_scipy, features: np.ndarray,
                           nodes: np.ndarray, fanouts: tuple[int, ...],
                           seed: int = 0) -> np.ndarray:
    """Numpy oracle of :func:`sampled_propagate` for tests (the same
    estimator, an independent recursive implementation; sampling.py:
    132-155)."""
    rng = np.random.default_rng(seed)
    csr = graph_scipy.tocsr()

    def estimate(v: int, depth: int) -> np.ndarray:
        if depth == len(fanouts):
            return features[v]
        lo, hi = csr.indptr[v], csr.indptr[v + 1]
        deg = hi - lo
        if deg == 0:
            return np.zeros(features.shape[1], features.dtype)
        f = fanouts[depth]
        picks = rng.integers(lo, hi, f)
        acc = np.zeros(features.shape[1], np.float64)
        for e in picks:
            acc += csr.data[e] * deg * estimate(csr.indices[e], depth + 1)
        return (acc / f).astype(features.dtype)

    return np.stack([estimate(int(v), 0) for v in nodes])
