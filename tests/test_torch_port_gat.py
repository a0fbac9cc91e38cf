"""The port's GAT (models/gat.py) and the Functions under it
(ops/autograd.py: edge scores, segment softmax) against the reference
on the same inputs: forwards and parameter gradients, from the
reference's parameters carried over with ``params_from_jax``.

Tolerances, relative to max|reference|: forwards 1e-5 (f32 sums in
another order), gradients 1e-4 (chains of such sums; the reference's
gradient also flows through its row max, which cancels exactly in real
arithmetic and to rounding in f32). The two-cluster test is ported from
tests/test_gat.py and trains with ``torch.optim.Adam``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.models import gat as ref_gat

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models import gat as port_gat
from sgc_tpu_torch.ops import autograd as port_ag
from sgc_tpu_torch.ops.spmm import row_sums

CPU = "cpu"
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small problems: when the suite runs
    in parallel workers, torch's thread pool is oversubscribed and its
    many short ops run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _graphs(n=48, e=300, seed=0, diag=True, hub=None, empty=None):
    """tests/test_gat.py's graph in both packages: duplicates summed,
    every row with a self-loop unless ``diag=False``; row ``hub`` (if
    given) joined to every column, row ``empty`` left with no edge."""
    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(e, np.float32),
                         (rng.integers(0, n, e), rng.integers(0, n, e))),
                        shape=(n, n)).tocsr()
    adj.sum_duplicates()
    if diag:
        adj.setdiag(1.0)
    adj = adj.tolil()
    if hub is not None:
        adj[hub, :] = 1.0
    if empty is not None:
        adj[empty, :] = 0.0
    adj = adj.tocsr()
    adj.eliminate_zeros()
    return RefGraph.from_scipy(adj), SparseGraph.from_scipy(adj).to(CPU)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("graph", [
    pytest.param(dict(diag=True), id="True"),
    pytest.param(dict(diag=False), id="False"),
    # a hub row of every column beside a row with no edge at all
    pytest.param(dict(diag=False, hub=5, empty=9), id="hub_and_empty_row")])
def test_segment_softmax_and_grad_match_reference(graph):
    rg, pg = _graphs(seed=1, **graph)
    deg = np.diff(pg.row_ptr.numpy())
    if "hub" in graph:
        assert deg[graph["hub"]] == pg.n_cols and deg[graph["empty"]] == 0
    logits = _np(2, pg.n_edges_padded)
    w = _np(3, pg.n_edges_padded)
    live = np.arange(pg.n_edges_padded) < pg.nnz

    def f(lg):
        return jnp.sum(ref_gat.segment_softmax(lg, rg.rows, rg.n_rows,
                                               jnp.asarray(live)) * w)

    want = ref_gat.segment_softmax(jnp.asarray(logits), rg.rows, rg.n_rows,
                                   jnp.asarray(live))
    want_grad = jax.grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = port_gat.segment_softmax(lt, pg)
    assert rel_err(got.detach().numpy(), want) <= TOL
    assert not got[pg.nnz:].any()
    (got * torch.from_numpy(w)).sum().backward()
    assert rel_err(lt.grad.numpy(), want_grad) <= GRAD_TOL
    sums = row_sums(pg, got.detach())
    has_edge = np.diff(pg.row_ptr.numpy()) > 0
    np.testing.assert_allclose(sums.numpy()[has_edge], 1.0, atol=1e-5)


def test_edge_scores_and_grads_match_reference():
    rg, pg = _graphs(seed=4)
    dst, src = _np(5, pg.n_rows), _np(6, pg.n_cols)
    g = _np(7, pg.n_edges_padded)
    g[pg.nnz:] = 0.0     # the backward reads live edges (GAT masks the rest)
    slope = 0.2

    def scores(d, s):
        return jax.nn.leaky_relu(d[rg.rows] + s[rg.cols], slope)

    def f(d, s):
        return jnp.sum(scores(d, s) * g)

    gd, gs = jax.grad(f, argnums=(0, 1))(jnp.asarray(dst), jnp.asarray(src))
    dt = torch.from_numpy(dst).requires_grad_(True)
    st = torch.from_numpy(src).requires_grad_(True)
    out = port_ag.EdgeScoresFn.apply(pg, dt, st, slope)
    want = np.asarray(scores(jnp.asarray(dst), jnp.asarray(src)))
    assert (want < 0).any() and (want > 0).any()
    np.testing.assert_array_equal(out.detach().numpy(), want)
    (out * torch.from_numpy(g)).sum().backward()
    assert rel_err(dt.grad.numpy(), gd) <= TOL
    assert rel_err(st.grad.numpy(), gs) <= TOL


@pytest.mark.parametrize("activation", ["elu", None])
def test_gat_layer_forward_and_grads_match_reference(activation):
    rg, pg = _graphs(seed=8)
    x = _np(9, 48, 12)
    p0 = ref_gat.init_gat_layer(jax.random.PRNGKey(0), 12, 6)
    act_ref = jax.nn.elu if activation else None
    act_port = torch.nn.functional.elu if activation else None
    w = _np(10, 48, 6)

    def f(p):
        return jnp.sum(ref_gat.gat_layer_apply(p, jnp.asarray(x), rg,
                                               activation=act_ref) * w)

    want = ref_gat.gat_layer_apply(p0, jnp.asarray(x), rg,
                                   activation=act_ref)
    want_grad = jax.grad(f)(p0)
    m = port_gat.params_from_jax(p0, device=CPU)
    got = port_gat.gat_layer_apply(m, torch.from_numpy(x), pg,
                                   activation=act_port)
    assert rel_err(got.detach().numpy(), want) <= TOL
    (got * torch.from_numpy(w)).sum().backward()
    for k in ("w", "a_src", "a_dst", "bias"):
        assert rel_err(getattr(m, k).grad.numpy(),
                       getattr(want_grad, k)) <= GRAD_TOL, k


@pytest.mark.parametrize("concat", [True, False])
def test_multi_head_gat_matches_reference(concat):
    rg, pg = _graphs(seed=11)
    x = _np(12, 48, 8)
    p0 = ref_gat.init_multi_head(jax.random.PRNGKey(1), 3, 8, 5)

    def f(p):
        return jnp.sum(ref_gat.multi_head_gat(p, jnp.asarray(x), rg,
                                              concat=concat) ** 2)

    want = ref_gat.multi_head_gat(p0, jnp.asarray(x), rg, concat=concat)
    want_grad = jax.grad(f)(p0)
    m = port_gat.params_from_jax(p0, device=CPU)
    assert m.n_heads == 3
    got = port_gat.multi_head_gat(m, torch.from_numpy(x), pg, concat=concat)
    assert got.shape == ((48, 15) if concat else (48, 5))
    assert rel_err(got.detach().numpy(), want) <= TOL
    (got ** 2).sum().backward()
    for k in ("w", "a_src", "a_dst", "bias"):
        assert rel_err(getattr(m, k).grad.numpy(),
                       getattr(want_grad, k)) <= GRAD_TOL, k


def test_gat_inits_and_inference_impls():
    g = torch.Generator().manual_seed(0)
    one = port_gat.init_gat_layer(g, 300, 40, device=CPU)
    assert one.n_heads == 1 and tuple(one.w.shape) == (300, 40)
    assert abs(float(one.w.detach().std()) - (2 / 340) ** 0.5) < 0.01
    assert not one.bias.any()
    stack = port_gat.init_multi_head(g, 4, 30, 8, device=CPU)
    assert tuple(stack.w.shape) == (4, 30, 8)
    assert tuple(stack.a_src.shape) == tuple(stack.bias.shape) == (4, 8)
    assert abs(float(stack.a_dst.detach().std()) - 0.1) < 0.05
    # the drop-in impls serve inference and agree with the segment path
    _, pg = _graphs(seed=13)
    x = torch.from_numpy(_np(14, 48, 30))
    with torch.no_grad():
        want = port_gat.multi_head_gat(stack, x, pg)
        for impl in ("tiled", "hybrid"):
            got = port_gat.multi_head_gat(stack, x, pg, impl=impl)
            assert rel_err(got.numpy(), want.numpy()) <= TOL


def test_gat_learns_two_clusters():
    rng = np.random.default_rng(7)
    n = 64
    blocks = np.repeat([0, 1], n // 2)
    r, c = np.triu_indices(n, 1)
    keep = rng.random(len(r)) < np.where(blocks[r] == blocks[c], 0.25, 0.01)
    adj = sp.coo_matrix((np.ones(keep.sum(), np.float32),
                         (r[keep], c[keep])), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    adj.setdiag(1.0)
    g = SparseGraph.from_scipy(adj.tocsr()).to(CPU)
    x = torch.from_numpy(rng.standard_normal((n, 8), dtype=np.float32))
    y = torch.from_numpy(blocks)

    p1 = port_gat.params_from_jax(
        ref_gat.init_gat_layer(jax.random.PRNGKey(2), 8, 16), device=CPU)
    p2 = port_gat.params_from_jax(
        ref_gat.init_gat_layer(jax.random.PRNGKey(3), 16, 2), device=CPU)
    opt = torch.optim.Adam(list(p1.parameters()) + list(p2.parameters()),
                           lr=5e-3)
    for _ in range(80):
        opt.zero_grad()
        logits = port_gat.gat_layer_apply(
            p2, port_gat.gat_layer_apply(p1, x, g), g, activation=None)
        torch.nn.functional.cross_entropy(logits, y).backward()
        opt.step()
    with torch.no_grad():
        preds = port_gat.gat_layer_apply(
            p2, port_gat.gat_layer_apply(p1, x, g), g,
            activation=None).argmax(1)
    assert float((preds == y).float().mean()) > 0.9
