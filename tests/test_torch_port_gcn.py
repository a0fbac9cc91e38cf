"""The port's train-through-the-graph path against the reference on the
same inputs: the transpose and its permutation, the degrees, the
differentiable SpMM (``ops/autograd.py::SpmmSegmentFn``), the two-layer
GCN (forward, gradients, ``train_gcn``, ``cli.citation --model GCN``) and
the deep GCN stack.

Inputs are made with numpy from a seed; the reference's parameters are
carried over with ``params_from_jax`` and its dropout masks passed in
(``jax.random`` and ``torch.Generator`` give different streams).
Tolerances, relative to max|reference|:

* the transpose, its permutation, ``stage_layers``: bit for bit;
* forwards: 1e-5 (f32 sums in another order);
* gradients: 1e-4 (the backward chains several such sums);
* ``train_gcn`` for 200 epochs from the reference's init at dropout 0:
  rtol 2e-4 / atol 2e-5, the bound the Adam heads are held to
  (tests/test_torch_port_citation.py);
* CLI accuracies: equal.

The gradient with respect to the edge values is compared on the live
edges ``[0, nnz)`` only: on the padding slots JAX's gradient is
``<G[n_rows-1], x[n_cols-1]>`` (the padding edges point there with value
0), while kernel D, and so the port, writes 0 by position.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.cli import citation as ref_citation
from sgc_tpu.graph.normalize import aug_normalized_adjacency
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.models import deep_gcn as ref_deep
from sgc_tpu.models import gcn as ref_gcn
from sgc_tpu.ops.spmm import spmm_segment as ref_spmm_segment
from sgc_tpu.train import loops as ref_loops
from sgc_tpu.utils.config import CitationConfig as RefConfig

from sgc_tpu_torch.cli import citation as port_citation
from sgc_tpu_torch.data.fixtures import write_planetoid
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models import deep_gcn as port_deep
from sgc_tpu_torch.models import gcn as port_gcn
from sgc_tpu_torch.ops import autograd as port_ag
from sgc_tpu_torch.ops import spmm as port_spmm
from sgc_tpu_torch.train import loops as port_loops
from sgc_tpu_torch.utils.config import CitationConfig

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


def _graphs(seed=0, n=120, e=600):
    """The same normalized graph in both packages."""
    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(e, np.float32),
                         (rng.integers(0, n, e), rng.integers(0, n, e))),
                        shape=(n, n))
    s = aug_normalized_adjacency(adj + adj.T)
    return RefGraph.from_scipy(s), SparseGraph.from_scipy(s).to(CPU)


def _x(seed, n, f):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(
        np.float32)


# ------------------------------------------------------------ transpose


def _rect_coo(seed, dup):
    """A rectangular matrix with duplicate (row, col) pairs when ``dup``."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, 70, 500), rng.integers(0, 50, 500)
    if dup:
        r, c = np.concatenate([r, r[:60]]), np.concatenate([c, c[:60]])
    v = rng.standard_normal(len(r)).astype(np.float32)
    return r, c, v


@pytest.mark.parametrize("dup", [False, True])
def test_transpose_matches_reference_bit_for_bit(dup):
    r, c, v = _rect_coo(1, dup)
    want = RefGraph.from_coo(r, c, v, 70, 50).transpose()
    host_g = SparseGraph.from_coo(r, c, v, 70, 50)
    for g in (host_g, host_g.to(CPU)):
        got, perm = g.transpose_perm()
        assert torch.equal(torch.as_tensor(got.rows),
                           torch.as_tensor(g.transpose().rows))
        for a in ("rows", "cols", "vals", "row_ptr"):
            np.testing.assert_array_equal(np.asarray(getattr(got, a)),
                                          np.asarray(getattr(want, a)))
        assert (got.nnz, got.shape) == (want.nnz, want.shape)
        perm = np.asarray(perm)
        assert perm.dtype == np.int32
        np.testing.assert_array_equal(np.asarray(got.vals)[: g.nnz],
                                      np.asarray(g.vals)[: g.nnz][perm])
        np.testing.assert_array_equal(np.asarray(got.cols)[: g.nnz],
                                      np.asarray(g.rows)[: g.nnz][perm])
    assert got.device == host_g.to(CPU).device


def test_degrees_match_reference():
    r, c, v = _rect_coo(2, True)
    v[::7] = 0.0
    rg = RefGraph.from_coo(r, c, v, 70, 50)
    g = SparseGraph.from_coo(r, c, v, 70, 50)
    for pg in (g, g.to(CPU)):
        assert rel_err(pg.degrees().numpy(), rg.degrees()) <= TOL
        np.testing.assert_array_equal(pg.binary_degrees().numpy(),
                                      np.asarray(rg.binary_degrees()))


# ----------------------------------------------------- differentiable spmm


@pytest.mark.parametrize("f", [1, 3, 16])
def test_spmm_segment_fn_grads_match_jax(f):
    rg, pg = _graphs(3)
    x = _x(4, pg.n_cols, f)
    w = _x(5, pg.n_rows, f)      # a loss weight, so G is not uniform

    def loss(vals, xx):
        return jnp.sum(ref_spmm_segment(rg.with_vals(vals), xx) * w)

    gv, gx = jax.grad(loss, argnums=(0, 1))(rg.vals, jnp.asarray(x))
    vals = pg.vals.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_ag.SpmmSegmentFn.apply(pg, vals, xt)
    assert rel_err(out.detach().numpy(),
                   ref_spmm_segment(rg, jnp.asarray(x))) <= TOL
    (out * torch.from_numpy(w)).sum().backward()
    assert rel_err(xt.grad.numpy(), gx) <= TOL
    nnz = pg.nnz
    assert rel_err(vals.grad[:nnz].numpy(), np.asarray(gv)[:nnz]) <= TOL
    assert not vals.grad[nnz:].any()        # kernel D: padding 0


def test_spmm_dispatcher_differentiates_and_refuses():
    rg, pg = _graphs(6)
    x = torch.from_numpy(_x(7, pg.n_cols, 5)).requires_grad_(True)
    for impl in ("auto", "segment", "chunked"):
        out = port_spmm.spmm(pg, x, impl=impl)
        assert out.grad_fn is not None
        (gx,) = torch.autograd.grad(out.sum(), x)
        want = jax.grad(lambda xx: jnp.sum(ref_spmm_segment(rg, xx)))(
            jnp.asarray(x.detach().numpy()))
        assert rel_err(gx.numpy(), want) <= TOL
    for impl in ("tiled", "hybrid", "blockdense"):
        with pytest.raises(ValueError, match="not differentiable"):
            port_spmm.spmm(pg, x, impl=impl)
    with pytest.raises(ValueError, match="not differentiable"):
        port_spmm.spmm_segment(pg, x)
    with pytest.raises(ValueError, match="not differentiable"):
        port_spmm.sddmm(pg, x, x)
    with torch.no_grad():       # no gradient wanted: every impl runs
        assert port_spmm.spmm(pg, x, impl="tiled").grad_fn is None


def test_transpose_cache_is_shared_by_reweightings():
    _, pg = _graphs(8)
    gt, perm = port_ag.transposed(pg)
    again = port_ag.transposed(pg.with_vals(pg.vals * 2))
    assert again[0] is gt and again[1] is perm
    vals = torch.arange(pg.n_edges_padded, dtype=torch.float32)
    on_t = port_ag.on_transpose(pg, vals)
    np.testing.assert_array_equal(on_t.vals[: pg.nnz].numpy(),
                                  vals[perm.long()].numpy())
    assert not on_t.vals[pg.nnz:].any()
    # the graph's own values: the cached transpose, which carries them
    assert port_ag.on_transpose(pg, pg.vals) is gt
    own = port_ag.on_transpose(pg, pg.vals.clone())
    assert own is not gt and torch.equal(own.vals, gt.vals)


# ------------------------------------------------------------------ GCN


@pytest.fixture(scope="module")
def gcn_problem():
    rg, pg = _graphs(9, n=150, e=900)
    x = _x(10, 150, 12)
    p0 = ref_gcn.init_gcn(jax.random.PRNGKey(0), 12, 8, 4)
    return rg, pg, x, p0


def test_init_gcn_shapes_and_bounds():
    m = port_gcn.init_gcn(torch.Generator().manual_seed(0), 400, 16, 3,
                          device=CPU)
    assert [tuple(p.shape) for p in m.parameters()] == [(400, 16), (16,),
                                                        (16, 3), (3,)]
    assert m.w1.abs().max() <= 1 / 20 and m.b1.abs().max() <= 1 / 20
    assert m.w2.abs().max() <= 1 / 4
    assert float(m.w1.detach().std()) > 0.8 * (1 / 20) / 3 ** 0.5


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_gcn_apply_and_grads_match_reference(gcn_problem, dropout):
    rg, pg, x, p0 = gcn_problem
    key = jax.random.PRNGKey(11)
    y = np.random.default_rng(12).integers(0, 4, 150)

    def loss(p):
        logits = ref_gcn.gcn_apply(p, jnp.asarray(x), rg,
                                   dropout_rate=dropout, dropout_key=key)
        return ref_loops.cross_entropy(logits[:60], jnp.asarray(y[:60]))

    want_loss, want = jax.value_and_grad(loss)(p0)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - dropout, (150, 8)))
    m = port_gcn.params_from_jax(p0, device=CPU)
    logits = port_gcn.gcn_apply(m, torch.from_numpy(x), pg,
                                dropout_rate=dropout,
                                keep_mask=torch.from_numpy(mask.copy()))
    labels, weights = port_loops.train_target(150, np.arange(60),
                                              torch.from_numpy(y[:60]))
    got_loss = port_loops.node_cross_entropy(logits, labels, weights)
    assert abs(float(got_loss.detach()) - float(want_loss)) <= TOL * abs(
        float(want_loss))
    if dropout == 0.0:
        ref_logits = ref_gcn.gcn_apply(p0, jnp.asarray(x), rg)
        assert rel_err(logits.detach().numpy(), ref_logits) <= TOL
    got_loss.backward()
    for k in ("w1", "b1", "w2", "b2"):
        assert rel_err(getattr(m, k).grad.numpy(),
                       getattr(want, k)) <= GRAD_TOL, k


def test_gcn_apply_draws_dropout_from_generator(gcn_problem):
    _, pg, x, p0 = gcn_problem
    m = port_gcn.params_from_jax(p0, device=CPU)
    xt = torch.from_numpy(x)
    full = port_gcn.gcn_apply(m, xt, pg)
    assert torch.equal(port_gcn.gcn_apply(m, xt, pg, dropout_rate=0.5),
                       full)      # no generator, no mask: no dropout
    a = port_gcn.gcn_apply(m, xt, pg, dropout_rate=0.5,
                           generator=torch.Generator().manual_seed(1))
    b = port_gcn.gcn_apply(m, xt, pg, dropout_rate=0.5,
                           generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, full)


def test_train_gcn_matches_reference(gcn_problem):
    rg, pg, x, p0 = gcn_problem
    # planted labels: on a problem the model can fit, training is
    # smooth; on random labels it memorizes, and rounding differences
    # between the packages grow chaotically after ~100 epochs
    y = (x @ np.random.default_rng(13).standard_normal((12, 4))).argmax(
        1).astype(np.int32)
    idx = np.arange(0, 150, 3)
    want, _ = ref_loops.train_gcn(p0, jnp.asarray(x), rg, jnp.asarray(idx),
                                  jnp.asarray(y[idx]), epochs=200,
                                  weight_decay=5e-4, lr=0.01, dropout=0.0)
    m0 = port_gcn.params_from_jax(p0, device=CPU)
    w0 = m0.w1.detach().clone()
    got, seconds = port_loops.train_gcn(
        m0, torch.from_numpy(x), pg, idx, torch.from_numpy(y[idx]),
        epochs=200, weight_decay=5e-4, lr=0.01, dropout=0.0)
    assert seconds > 0 and torch.equal(m0.w1, w0)    # input untouched
    assert not any(p.requires_grad for p in got.parameters())
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_train_gcn_with_dropout_repeats_and_learns(gcn_problem):
    _, pg, x, p0 = gcn_problem
    y = (x[:, 0] > 0).astype(np.int64)
    idx = np.arange(0, 150, 2)
    kw = dict(epochs=60, weight_decay=5e-4, lr=0.02, dropout=0.5, seed=3)
    runs = [port_loops.train_gcn(port_gcn.params_from_jax(p0, device=CPU),
                                 torch.from_numpy(x), pg, idx,
                                 torch.from_numpy(y[idx]), **kw)[0]
            for _ in range(2)]
    for a, b in zip(runs[0].parameters(), runs[1].parameters()):
        assert torch.equal(a, b)
    other = port_loops.train_gcn(port_gcn.params_from_jax(p0, device=CPU),
                                 torch.from_numpy(x), pg, idx,
                                 torch.from_numpy(y[idx]), **{**kw,
                                                              "seed": 4})[0]
    assert not torch.equal(other.w1, runs[0].w1)     # the seed draws masks


@pytest.fixture(scope="module")
def planetoid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("planetoid_gcn")
    write_planetoid(root, "cora", 900, 3000, 60, 4, 28, 200, seed=1)
    return root


def test_citation_gcn_matches_reference(planetoid_root, monkeypatch):
    p0 = ref_gcn.init_gcn(jax.random.PRNGKey(42), 60, 16, 4)

    def init(generator, nfeat, nhid, nclass, device=None):
        assert (nfeat, nhid, nclass) == (60, 16, 4)
        return port_gcn.params_from_jax(p0, device=device)

    monkeypatch.setattr(port_citation, "get_model",
                        lambda name: (init, port_gcn.gcn_apply))
    kw = dict(dataset="cora", model="GCN", hidden=16, epochs=200, lr=0.01,
              weight_decay=5e-4)
    want = ref_citation.run(RefConfig(**kw), str(planetoid_root))
    got = port_citation.run(CitationConfig(**kw), str(planetoid_root),
                            device=CPU)
    assert set(got) == set(want)
    for k in ("val_accuracy", "test_accuracy", "precompute_time"):
        assert got[k] == want[k], k
    assert got["train_time"] > 0 and got["val_accuracy"] > 0.5


def test_citation_gcn_tuned_runs(planetoid_root):
    got = port_citation.run(CitationConfig(dataset="cora", model="GCN",
                                           tuned=True),
                            str(planetoid_root), device=CPU)
    assert got["precompute_time"] == 0.0
    assert got["test_accuracy"] > 0.5      # 4 classes: 2x chance


# ------------------------------------------------------------- deep GCN


@pytest.fixture(scope="module")
def deep_problem():
    rg, pg = _graphs(14, n=96, e=700)
    x = _x(15, 96, 12)
    p0 = ref_deep.init_deep_gcn(jax.random.PRNGKey(1), 12, 8, 3, n_layers=4)
    return rg, pg, x, p0


@pytest.mark.parametrize("residual", [True, False])
def test_deep_gcn_forward_and_grads_match_reference(deep_problem, residual):
    rg, pg, x, p0 = deep_problem

    def loss(p):
        return jnp.sum(ref_deep.deep_gcn_apply(p, jnp.asarray(x), rg,
                                               residual=residual) ** 2)

    want = jax.grad(loss)(p0)
    m = port_deep.params_from_jax(p0, device=CPU)
    out = port_deep.deep_gcn_apply(m, torch.from_numpy(x), pg,
                                   residual=residual)
    assert rel_err(out.detach().numpy(), ref_deep.deep_gcn_apply(
        p0, jnp.asarray(x), rg, residual=residual)) <= TOL
    (out ** 2).sum().backward()
    for k in port_deep._FIELDS:
        assert rel_err(getattr(m, k).grad.numpy(),
                       getattr(want, k)) <= GRAD_TOL, k


def test_deep_gcn_remat_gives_the_same_bits(deep_problem):
    _, pg, x, p0 = deep_problem
    grads = []
    for remat in (True, False):
        m = port_deep.params_from_jax(p0, device=CPU)
        loss = (port_deep.deep_gcn_apply(m, torch.from_numpy(x), pg,
                                         remat=remat) ** 2).sum()
        loss.backward()
        grads.append([loss.detach()] + [p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_deep_gcn_init_and_stages():
    p = ref_deep.init_deep_gcn(jax.random.PRNGKey(3), 12, 8, 3, n_layers=9)
    m = port_deep.params_from_jax(p, device=CPU)
    assert m.n_layers == p.n_layers == 9
    for s in (1, 2, 3, 4, 7, 0):
        want = ref_deep.stage_layers(p, s)
        got = port_deep.stage_layers(m, s)
        assert len(got) == len(want)
        for (gw, gb), (ww, wb) in zip(got, want):
            np.testing.assert_array_equal(gw.detach().numpy(),
                                          np.asarray(ww))
            np.testing.assert_array_equal(gb.detach().numpy(),
                                          np.asarray(wb))
    g = torch.Generator().manual_seed(0)
    d = port_deep.init_deep_gcn(g, 300, 64, 5, n_layers=8, device=CPU)
    assert tuple(d.w_hidden.shape) == (6, 64, 64) and not d.b_hidden.any()
    assert abs(float(d.w_hidden.detach().std()) - (2 / 128) ** 0.5) < 0.01
    two = port_deep.init_deep_gcn(g, 30, 8, 2, n_layers=2, device=CPU)
    assert two.n_layers == 2 and port_deep.deep_gcn_apply(
        two, torch.ones(96, 30), _graphs(16, n=96)[1]).shape == (96, 2)
    with pytest.raises(ValueError, match=">= 2"):
        port_deep.init_deep_gcn(g, 3, 4, 2, n_layers=1, device=CPU)
