"""The port's neighborhood sampler (``sgc_tpu_torch/ops/sampling.py``)
against the reference's (``sgc_tpu/ops/sampling.py``), on the CPU.

The two packages draw from different random streams, so parity shares
inputs, not seeds: the offsets JAX draws are re-derived here with the
reference's own key splits (sampling.py:104-106) and bound (:67) and
handed to the port's gather, which must give ``nbr`` equal and ``w``
equal bit for bit; the port's tree reduction runs on the tree the
reference sampled and must agree with ``sampled_propagate`` to rtol 1e-6
(f32 sum order only), atol 1e-6 x max|reference|. The port's own draw is
held to its range and, through the estimator, to the exact ``S @ x``
under the reference's statistical bound (test_sampling_transformer.py:
54-71).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.graph.normalize import aug_normalized_adjacency
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops import sampling as ref

from sgc_tpu_torch.graph.sparse import EDGE_PAD_MULTIPLE
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.ops import sampling as port
from sgc_tpu_torch.ops.spmm import spmm

CPU = torch.device("cpu")


def _norm_adj(n, e, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    adj = sp.coo_matrix((np.ones(e, np.float32), (src, dst)), shape=(n, n))
    return aug_normalized_adjacency(adj + adj.T)


def _graphs(mat):
    return RefGraph.from_scipy(mat), PortGraph.from_scipy(mat).to(CPU)


def _jax_tree(rg, nodes, key, fanouts):
    """The reference's sampled tree for ``sampled_propagate(..., key,
    fanouts)``, with the offsets it drew at each hop."""
    frontiers, weights, offsets = [jnp.asarray(nodes, jnp.int32)], [], []
    starts, degrees = ref._neighbor_table(rg)
    for f in fanouts:
        key, sub = jax.random.split(key)
        flat = frontiers[-1].reshape(-1)
        d = degrees[flat]
        offsets.append(np.array(jax.random.randint(
            sub, (flat.shape[0], f), 0, jnp.maximum(d, 1)[:, None])))
        nbr, w = ref.sample_neighbors(rg, flat, sub, f)
        frontiers.append(nbr.reshape(-1))
        weights.append(w.reshape(-1, f))
    return ([np.array(a) for a in frontiers],
            [np.array(a) for a in weights], offsets)


@pytest.mark.parametrize("fanouts,seed", [((8,), 0), ((25, 10), 1),
                                          ((5, 3, 2), 2)])
def test_gather_matches_reference_given_its_offsets(fanouts, seed):
    rg, pg = _graphs(_norm_adj(96, 700, seed))
    nodes = np.arange(0, 96, 3)
    frontiers, weights, offsets = _jax_tree(rg, nodes,
                                            jax.random.PRNGKey(seed), fanouts)
    for t, f in enumerate(fanouts):
        nbr, w = port.gather_neighbors(
            pg, torch.from_numpy(frontiers[t].reshape(-1)),
            torch.from_numpy(offsets[t]))
        np.testing.assert_array_equal(nbr.numpy().reshape(-1),
                                      frontiers[t + 1])
        assert w.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), weights[t])


@pytest.mark.parametrize("fanouts,seed", [((8,), 3), ((25, 10), 4),
                                          ((5, 3, 2), 5)])
def test_tree_reduction_matches_sampled_propagate(fanouts, seed):
    rg, pg = _graphs(_norm_adj(80, 600, seed))
    x = np.random.default_rng(seed).standard_normal((80, 12)).astype(
        np.float32)
    nodes = np.arange(0, 80, 2)
    key = jax.random.PRNGKey(seed)
    frontiers, weights, _ = _jax_tree(rg, nodes, key, fanouts)
    want = np.asarray(ref.sampled_propagate(
        rg, jnp.asarray(x), jnp.asarray(nodes, jnp.int32), key, fanouts))
    got = port.reduce_tree(torch.from_numpy(x),
                           [torch.from_numpy(a) for a in frontiers],
                           [torch.from_numpy(a) for a in weights], fanouts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_isolated_node_samples_itself_with_zero_weight():
    adj = sp.coo_matrix((np.ones(2, np.float32), ([0, 1], [1, 0])),
                        shape=(4, 4)).tocsr()
    rg, pg = _graphs(adj)
    nbr, w = port.sample_neighbors(pg, torch.tensor([3, 0]),
                                   torch.Generator().manual_seed(0), 4)
    assert nbr.dtype == torch.int32
    np.testing.assert_array_equal(nbr[0].numpy(), [3, 3, 3, 3])
    np.testing.assert_array_equal(w[0].numpy(), [0.0] * 4)
    np.testing.assert_array_equal(nbr[1].numpy(), [1, 1, 1, 1])
    ref_nbr, ref_w = ref.sample_neighbors(rg, jnp.asarray([3, 0], jnp.int32),
                                          jax.random.PRNGKey(0), 4)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(ref_nbr))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))


def test_isolated_last_row_with_unpadded_edges():
    """nnz a multiple of the padding leaves no padding edge: the isolated
    last row's start is one past the edge arrays, and the port must not
    index there (on CUDA that gather would end the process)."""
    n = 40
    pairs = np.array([(r, c) for r in range(n - 1) for c in range(n)])
    pairs = pairs[:EDGE_PAD_MULTIPLE]
    mat = sp.coo_matrix((np.full(len(pairs), 0.5, np.float32),
                         (pairs[:, 0], pairs[:, 1])), shape=(n, n)).tocsr()
    rg, pg = _graphs(mat)
    assert pg.nnz == EDGE_PAD_MULTIPLE == pg.n_edges_padded
    assert int(pg.row_ptr[n - 1]) == pg.nnz
    nodes = torch.tensor([n - 1, 0, n - 1])
    gen = torch.Generator().manual_seed(1)
    nbr, w = port.sample_neighbors(pg, nodes, gen, 6)
    np.testing.assert_array_equal(nbr[0].numpy(), [n - 1] * 6)
    np.testing.assert_array_equal(w[[0, 2]].numpy(), np.zeros((2, 6)))
    assert bool((w[1] == 0.5 * 40).all())
    ref_nbr, ref_w = ref.sample_neighbors(
        rg, jnp.asarray([n - 1], jnp.int32), jax.random.PRNGKey(0), 6)
    np.testing.assert_array_equal(nbr[0].numpy(), np.asarray(ref_nbr)[0])
    np.testing.assert_array_equal(w[0].numpy(), np.asarray(ref_w)[0])
    x = torch.ones((n, 3))
    est = port.sampled_propagate(pg, x, nodes, gen, (4, 2))
    np.testing.assert_array_equal(est[[0, 2]].numpy(), np.zeros((2, 3)))


@pytest.mark.parametrize("degree", [0, 1, 2, 23_980])
def test_offsets_stay_in_range(degree):
    gen = torch.Generator().manual_seed(degree)
    degrees = torch.full((64,), degree, dtype=torch.int32)
    offs = torch.cat([port.draw_offsets(degrees, 512, gen)
                      for _ in range(8)])
    assert offs.dtype == torch.int64 and offs.shape == (512, 512)
    assert int(offs.min()) >= 0
    assert int(offs.max()) <= max(degree, 1) - 1
    if degree == 23_980:
        # 262,144 draws over 23,980 values: both ends are reached, and
        # the mean sits within 1% of the range of the uniform's
        assert int(offs.min()) == 0 and int(offs.max()) >= degree - 3
        assert abs(offs.double().mean().item() - (degree - 1) / 2) < (
            0.01 * degree)
    if degree == 2:
        assert set(offs.unique().tolist()) == {0, 1}


def test_port_sampler_is_unbiased_against_exact_hop():
    """The mean of many sampled hops converges to the exact S @ x row,
    under the reference's bound (atol 0.15, rtol 0.2, 300 draws)."""
    mat = _norm_adj(32, 128, 1)
    pg = PortGraph.from_scipy(mat).to(CPU)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (32, 8), dtype=np.float32))
    exact = spmm(pg, x).numpy()
    np.testing.assert_allclose(exact, mat @ x.numpy(), rtol=1e-5, atol=1e-6)
    nodes = torch.arange(32)
    gen = torch.Generator().manual_seed(7)
    acc = np.zeros((32, 8), np.float64)
    trials = 300
    for _ in range(trials):
        acc += port.sampled_propagate(pg, x, nodes, gen, (8,)).numpy()
    np.testing.assert_allclose(acc / trials, exact, atol=0.15, rtol=0.2)


def test_sampled_sgc_infer_matches_reference_head_on_a_shared_tree():
    """The head on the port's estimate of a tree the reference sampled
    equals the reference's ``sampled_sgc_infer`` to f32 tolerance."""
    from sgc_tpu.models.sgc import init_sgc as ref_init

    from sgc_tpu_torch.models.sgc import params_from_jax, sgc_apply

    rg, pg = _graphs(_norm_adj(64, 512, 6))
    x = np.random.default_rng(5).standard_normal((64, 12)).astype(
        np.float32)
    p = ref_init(jax.random.PRNGKey(0), 12, 5)
    nodes = np.arange(10)
    key = jax.random.PRNGKey(1)
    want = np.asarray(ref.sampled_sgc_infer(p, rg, jnp.asarray(x), nodes,
                                            key, (4, 4)))
    frontiers, weights, _ = _jax_tree(rg, nodes, key, (4, 4))
    est = port.reduce_tree(torch.from_numpy(x),
                           [torch.from_numpy(a) for a in frontiers],
                           [torch.from_numpy(a) for a in weights], (4, 4))
    head = params_from_jax(np.asarray(p.w), np.asarray(p.b), device=CPU)
    got = sgc_apply(head, est).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    own = port.sampled_sgc_infer(head, pg, torch.from_numpy(x), nodes,
                                 torch.Generator().manual_seed(1), (4, 4))
    assert own.shape == (10, 5) and bool(torch.isfinite(own).all())


def test_host_oracle_agrees_with_the_port_in_expectation():
    """The copied numpy oracle and the port's sampler estimate the same
    quantity: their means over many draws agree with the exact two-hop
    product under the reference's bound."""
    mat = _norm_adj(24, 96, 8)
    pg = PortGraph.from_scipy(mat).to(CPU)
    x = np.random.default_rng(9).standard_normal((24, 4)).astype(np.float32)
    exact = mat @ (mat @ x)
    nodes = np.arange(24)
    gen = torch.Generator().manual_seed(3)
    port_acc = np.zeros((24, 4))
    host_acc = np.zeros((24, 4))
    trials = 200
    for t in range(trials):
        port_acc += port.sampled_propagate(pg, torch.from_numpy(x),
                                           torch.from_numpy(nodes), gen,
                                           (6, 6)).numpy()
        host_acc += port.sampled_propagate_host(mat, x, nodes, (6, 6),
                                                seed=t)
    for acc in (port_acc, host_acc):
        np.testing.assert_allclose(acc / trials, exact, atol=0.15, rtol=0.2)
