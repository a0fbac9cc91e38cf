"""The port's citation path against the reference on the same inputs:
normalizations, the Planetoid loader, propagation (every ``sgc_precompute``
impl, with and without ``out_rows``), the Adam trainers, the metrics, the
tuned config, and the citation and sweep CLIs.

Inputs are made with numpy from a seed and fed to both packages; the
Planetoid files are written by ``sgc_tpu_torch.data.fixtures`` in the
published format (a Cora-like set and a Citeseer-like one with isolated
test nodes). Tolerances:

* host arrays (normalizations, ``row_normalize``, ``symmetrize_max``, the
  loader's graph, features and labels) and the metrics: exact;
* ``standardize_features`` and ``normalize_adjacency_device``: 1e-6
  relative (the sums run in another order);
* propagation: 1e-5 relative to max|ref| (f32 summation order; the
  ``blockdense`` impl at the reference's default bf16 x on both sides);
* the Adam heads after 100 epochs at lr 0.2: rtol 2e-4, atol 2e-5, the
  reference's own vmapped-vs-sequential bound: ``torch.optim.Adam`` folds
  the bias corrections into its step where optax divides the moments,
  which drifts by rounding (measured 1.2e-5 of 1.45 here at wd 5e-6);
* CLI accuracies: equal, from the reference's init carried over with
  ``params_from_jax`` (the two packages' random streams differ).
"""

import importlib
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.cli import citation as ref_citation
from sgc_tpu.cli import sweep as ref_sweep
from sgc_tpu.data.planetoid import load_citation as ref_load
from sgc_tpu.graph import normalize as ref_norm
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.models.sgc import init_sgc as ref_init
from sgc_tpu.train import loops as ref_loops
from sgc_tpu.train import metrics as ref_metrics
from sgc_tpu.utils.config import CitationConfig as RefConfig

from sgc_tpu_torch.cli import citation as port_citation
from sgc_tpu_torch.cli import sweep as port_sweep
from sgc_tpu_torch.data.fixtures import write_planetoid
from sgc_tpu_torch.data.planetoid import load_citation
from sgc_tpu_torch.graph import normalize as port_norm
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models.registry import get_model, register_model
from sgc_tpu_torch.models.sgc import init_sgc, params_from_jax, sgc_apply
from sgc_tpu_torch.ops.spmm_blockdense import _split_cached
from sgc_tpu_torch.ops.spmm_hybrid import _split_cached as hybrid_split
from sgc_tpu_torch.train import loops as port_loops
from sgc_tpu_torch.train import metrics as port_metrics
from sgc_tpu_torch.utils.config import CitationConfig
from sgc_tpu_torch.utils.profiling import ScalarWriter

# the reference's ops package exports a function named propagate
ref_prop = importlib.import_module("sgc_tpu.ops.propagate")
port_prop = importlib.import_module("sgc_tpu_torch.ops.propagate")

TOL = 1e-5
CPU = "cpu"


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def random_adjacency(seed=0, n=300, m=1500):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    adj = sp.coo_matrix((np.ones(m, np.float32), (r, c)), shape=(n, n))
    return (adj + adj.T).tocsr()


@pytest.fixture(scope="module")
def planetoid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("planetoid")
    write_planetoid(root, "cora", 900, 3000, 60, 4, 28, 200, seed=1)
    write_planetoid(root, "citeseer", 960, 3000, 60, 4, 28, 200, seed=2,
                    test_gaps=30)
    return root


@pytest.fixture(scope="module")
def community_graph():
    """A graph with dense diagonal cells and a sparse tail at F = 300, so
    the block-dense and hybrid splits both have cells and a remainder."""
    rng = np.random.default_rng(0)
    n, f = 3000, 300
    r, c = [], []
    for b in range(4):
        r.append(b * 512 + rng.integers(0, 512, 6000))
        c.append(b * 512 + rng.integers(0, 512, 6000))
    r.append(rng.integers(0, n, 3000))
    c.append(rng.integers(0, n, 3000))
    r, c = np.concatenate(r), np.concatenate(c)
    adj = sp.coo_matrix((np.ones(len(r), np.float32), (r, c)), shape=(n, n))
    s = ref_norm.aug_normalized_adjacency(adj + adj.T)
    x = rng.standard_normal((n, f)).astype(np.float32)
    idx = np.sort(rng.choice(n, 400, replace=False))
    return (RefGraph.from_scipy(s), SparseGraph.from_scipy(s).to(CPU), x,
            idx)


# -------------------------------------------------------- normalizations


@pytest.mark.parametrize("name", ["AugNormAdj", "TextAugNormAdj",
                                  "RWalkAdj", "NormAdj", "NoNorm"])
def test_normalizations_match_reference(name):
    adj = random_adjacency().tolil()
    adj[5, :] = 0   # an empty row: its inverse degree must be 0
    adj = adj.tocsr()
    adj.eliminate_zeros()
    want = ref_norm.fetch_normalization(name)(adj)
    got = port_norm.fetch_normalization(name)(adj)
    assert got.format == want.format == "coo"
    np.testing.assert_array_equal(got.toarray(), want.toarray())


def test_register_normalization_and_unknown_name():
    port_norm.register_normalization("Twice", lambda a: sp.coo_matrix(2 * a))
    adj = random_adjacency(1, 20, 40)
    np.testing.assert_array_equal(
        port_norm.fetch_normalization("Twice")(adj).toarray(),
        2 * adj.toarray())
    with pytest.raises(ValueError, match="Invalid normalization"):
        port_norm.fetch_normalization("nope")


@pytest.mark.parametrize("sparse", [True, False])
def test_row_normalize_matches_reference(sparse):
    rng = np.random.default_rng(3)
    mx = rng.random((50, 30)).astype(np.float32)
    mx[rng.random((50, 30)) < 0.7] = 0
    mx[4] = 0
    arg = sp.csr_matrix(mx) if sparse else mx
    want = ref_norm.row_normalize(arg)
    got = port_norm.row_normalize(arg)
    assert sp.issparse(got) == sparse
    if sparse:
        got, want = got.toarray(), want.toarray()
    np.testing.assert_array_equal(got, want)


def test_symmetrize_max_matches_reference():
    rng = np.random.default_rng(4)
    r, c = rng.integers(0, 80, 400), rng.integers(0, 80, 400)
    adj = sp.coo_matrix((rng.random(400).astype(np.float32), (r, c)),
                        shape=(80, 80))
    # each side gets its own copy: scipy may sum duplicates in place
    want = ref_norm.symmetrize_max(adj.copy())
    got = port_norm.symmetrize_max(adj.copy())
    np.testing.assert_array_equal(got.toarray(), want.toarray())


def test_normalize_adjacency_device_matches_reference():
    adj = random_adjacency(5) + sp.eye(300, dtype=np.float32)
    rg = RefGraph.from_scipy(sp.csr_matrix(adj))
    pg = SparseGraph.from_scipy(sp.csr_matrix(adj)).to(CPU)
    want = np.asarray(ref_norm.normalize_adjacency_device(rg).vals)
    got = port_norm.normalize_adjacency_device(pg)
    assert got.device == pg.device
    assert rel_err(got.vals.numpy(), want) <= 1e-6
    assert not got.vals[pg.nnz:].any()        # padding stays 0
    with pytest.raises(ValueError, match="device"):
        port_norm.normalize_adjacency_device(SparseGraph.from_scipy(adj))


def test_standardize_features_matches_reference():
    rng = np.random.default_rng(6)
    x = (rng.normal(5.0, 2.0, (400, 30))).astype(np.float32)
    want = np.asarray(ref_norm.standardize_features(jnp.asarray(x)))
    got = port_norm.standardize_features(torch.from_numpy(x)).numpy()
    assert rel_err(got, want) <= 1e-6


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("dataset", ["cora", "citeseer"])
def test_load_citation_matches_reference(planetoid_root, dataset):
    want = ref_load(dataset, data_path=str(planetoid_root))
    got = load_citation(dataset, data_path=str(planetoid_root), device=CPU)
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(want.features))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    for a in ("rows", "cols", "vals", "row_ptr"):
        np.testing.assert_array_equal(getattr(got.graph, a).numpy(),
                                      np.asarray(getattr(want.graph, a)))
    assert (got.graph.nnz, got.graph.shape) == (want.graph.nnz,
                                                want.graph.shape)
    for a in ("idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    assert got.n_classes == want.n_classes == 4
    assert got.graph.device.type == got.features.device.type == "cpu"


def test_citeseer_fixture_zero_fills_isolated_test_nodes(planetoid_root):
    got = load_citation("citeseer", data_path=str(planetoid_root),
                        device=CPU)
    test = set(got.idx_test.tolist())
    gaps = [i for i in range(int(got.idx_test.min()),
                             int(got.idx_test.max()) + 1) if i not in test]
    assert len(gaps) == 30
    assert not got.features[gaps].any()
    assert got.features.shape[0] == 960


def test_data_dir_search_order(tmp_path, monkeypatch):
    from sgc_tpu_torch.utils.paths import data_dir

    assert data_dir(tmp_path) == tmp_path
    monkeypatch.setenv("SGC_TPU_DATA", str(tmp_path / "env"))
    assert data_dir(None) == tmp_path / "env"
    monkeypatch.delenv("SGC_TPU_DATA")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        data_dir(None)
    (tmp_path / "data").mkdir()
    assert data_dir(None) == tmp_path / "data"
    # a directory without the files: the loader names the missing one
    with pytest.raises(FileNotFoundError, match="ind.cora.x"):
        load_citation("cora", device=CPU)


# ----------------------------------------------------------- propagation


def test_propagate_collect_hops_matches_reference(community_graph):
    rg, pg, x, _ = community_graph
    want, want_hops = ref_prop.propagate(jnp.asarray(x), rg, 3,
                                         collect_hops=True)
    got, hops = port_prop.propagate(torch.from_numpy(x), pg, 3,
                                    collect_hops=True)
    assert len(hops) == 3 and hops[-1] is got
    for g, w in zip(hops, want_hops):
        assert rel_err(g.numpy(), w) <= TOL


@pytest.mark.parametrize("name", ["appnp", "ssgc"])
def test_propagators_match_reference(community_graph, name):
    rg, pg, x, _ = community_graph
    want = ref_prop.fetch_propagator(name)(jnp.asarray(x), rg, 4)
    got = port_prop.fetch_propagator(name)(torch.from_numpy(x), pg, 4)
    assert rel_err(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="unknown propagator"):
        port_prop.fetch_propagator("gcn")


@pytest.mark.parametrize("out_rows", [False, True])
@pytest.mark.parametrize("impl", ["auto", "segment", "chunked", "tiled",
                                  "hybrid", "blockdense"])
def test_sgc_precompute_matches_reference(community_graph, impl, out_rows):
    rg, pg, x, idx = community_graph
    rows = idx if out_rows else None
    ref_impl = "pallas" if impl == "tiled" else impl
    want, _ = ref_prop.sgc_precompute(jnp.asarray(x), rg, 2, impl=ref_impl,
                                      out_rows=rows)
    got, seconds = port_prop.sgc_precompute(torch.from_numpy(x), pg, 2,
                                            impl=impl, out_rows=rows)
    assert seconds > 0
    assert rel_err(got.numpy(), want) <= TOL


def test_community_graph_splits_have_cells_and_remainder(community_graph):
    _, pg, x, _ = community_graph
    split, _ = _split_cached(pg, x.shape[1], 512, 512, pg.device)
    assert split.n_cells and split.sparse_edges
    hsplit, _ = hybrid_split(pg, x.shape[1], 512, 512, 1024, None, pg.device)
    assert hsplit.dense_edges and hsplit.sparse_edges


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_sgc_precompute_out_rows_is_bit_equal(community_graph, degree):
    _, pg, x, idx = community_graph
    xt = torch.from_numpy(x)
    full, _ = port_prop.sgc_precompute(xt, pg, degree)
    sub, _ = port_prop.sgc_precompute(xt, pg, degree, out_rows=idx)
    assert torch.equal(sub, full[idx])
    with pytest.raises(ValueError, match="out_rows"):
        port_prop.sgc_precompute(xt, pg, degree, out_rows=[pg.n_rows])
    with pytest.raises(ValueError, match="impl"):
        port_prop.sgc_precompute(xt, pg, degree, impl="pallas")


# -------------------------------------------------------------- training


@pytest.fixture(scope="module")
def head_problem():
    rng = np.random.default_rng(7)
    n, f, c = 140, 200, 7
    y = rng.integers(0, c, n).astype(np.int32)
    x = (rng.standard_normal((c, f))[y] * 0.05
         + rng.random((n, f)) * 0.01).astype(np.float32)
    p0 = ref_init(jax.random.PRNGKey(42), f, c)
    return x, y, p0


def _port_head(p0):
    return params_from_jax(np.asarray(p0.w), np.asarray(p0.b), device=CPU)


@pytest.mark.parametrize("wd", [5e-6, 1e-3])
def test_train_regression_matches_reference(head_problem, wd, tmp_path):
    x, y, p0 = head_problem
    want, _ = ref_loops.train_regression(p0, jnp.asarray(x), jnp.asarray(y),
                                         100, wd, 0.2)
    m0 = _port_head(p0)
    w0 = m0.w.detach().clone()
    with ScalarWriter(tmp_path / "loss.jsonl") as writer:
        got, seconds = port_loops.train_regression(
            m0, torch.from_numpy(x), torch.from_numpy(y), 100, wd, 0.2,
            writer=writer)
    assert seconds > 0 and torch.equal(m0.w, w0)   # input head untouched
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=2e-4,
                               atol=2e-5)
    lines = (tmp_path / "loss.jsonl").read_text().splitlines()
    assert len(lines) == 100 and '"tag": "train/loss"' in lines[0]


def test_train_regression_many_matches_sequential(head_problem):
    x, y, p0 = head_problem
    wds = [1e-6, 1e-4, 1e-2]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    heads, losses, seconds = port_loops.train_regression_many(
        _port_head(p0), xt, yt, wds, 50, 0.2)
    assert losses.shape == (3, 50) and seconds > 0
    for head, wd in zip(heads, wds):
        seq, _ = port_loops.train_regression(_port_head(p0), xt, yt, 50, wd,
                                             0.2)
        np.testing.assert_allclose(head.w.numpy(), seq.w.numpy(),
                                   rtol=2e-4, atol=2e-5)
    ref_heads, ref_losses, _ = ref_loops.train_regression_many(
        p0, jnp.asarray(x), jnp.asarray(y), wds, 50, 0.2)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                               rtol=2e-4, atol=2e-5)
    for i, head in enumerate(heads):
        np.testing.assert_allclose(head.w.numpy(),
                                   np.asarray(ref_heads.w[i]), rtol=2e-4,
                                   atol=2e-5)


# --------------------------------------------------------------- metrics


def test_metrics_match_reference_exactly():
    rng = np.random.default_rng(11)
    for n, c in ((200, 5), (1000, 3), (37, 9)):
        logits = rng.standard_normal((n, c)).astype(np.float32)
        labels = rng.integers(0, c, n).astype(np.int32)
        preds = logits.argmax(1)
        lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
        assert port_metrics.accuracy(lt, yt) == ref_metrics.accuracy(
            jnp.asarray(logits), jnp.asarray(labels))
        assert port_metrics.f1(lt, yt) == ref_metrics.f1(
            jnp.asarray(logits), jnp.asarray(labels))
        for name in ("f1_macro", "f1_weighted", "optimized_precision"):
            assert (getattr(port_metrics, name)(torch.from_numpy(preds), yt)
                    == getattr(ref_metrics, name)(preds, labels)), name


# ------------------------------------------------------- models, config


def test_xavier_init_and_output_dropout():
    g = torch.Generator().manual_seed(3)
    m = init_sgc(g, 400, 100, init="xavier_normal", device=CPU)
    std = float(m.w.detach().std())
    assert abs(std - (2.0 / 500) ** 0.5) < 0.05 * std
    assert m.b.abs().max() <= 1 / 20
    with pytest.raises(ValueError, match="init"):
        init_sgc(g, 4, 2, init="kaiming", device=CPU)
    x = torch.ones((2000, 400))
    full = sgc_apply(m, x)
    assert torch.equal(sgc_apply(m, x, dropout_rate=0.5), full)  # no gen
    out = sgc_apply(m, x, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(out[kept], full[kept] / 0.75)


def test_registry():
    init_fn, apply_fn = get_model("SGC")
    assert init_fn is init_sgc and apply_fn is sgc_apply
    with pytest.raises(NotImplementedError, match="item 11"):
        get_model("GCN")
    with pytest.raises(NotImplementedError, match="not implemented"):
        get_model("MLP")
    register_model("MLP", init_sgc, sgc_apply)
    assert get_model("MLP")[0] is init_sgc


@pytest.mark.parametrize("dataset,model,tuned", [
    ("cora", "SGC", True), ("pubmed", "SGC", True), ("citeseer", "GCN", True),
    ("cora", "SGC", False), ("nope", "SGC", True)])
def test_citation_config_resolve_matches_reference(dataset, model, tuned):
    want = RefConfig(dataset=dataset, model=model, tuned=tuned).resolve()
    got = CitationConfig(dataset=dataset, model=model, tuned=tuned).resolve()
    assert vars(got) == vars(want)


# ------------------------------------------------------------------ CLIs


def _carry_init(monkeypatch, module, attr):
    """Replace ``module.attr`` (the port's init) with one returning the
    reference's ``init_sgc(PRNGKey(seed))`` values."""
    def init(generator, nfeat, nclass, bias=True, device=None, **kw):
        p = ref_init(jax.random.PRNGKey(42), nfeat, nclass, bias=bias)
        return params_from_jax(np.asarray(p.w),
                               None if p.b is None else np.asarray(p.b),
                               device=device)
    if attr == "get_model":
        monkeypatch.setattr(module, attr, lambda name: (init, sgc_apply))
    else:
        monkeypatch.setattr(module, attr, init)


@pytest.mark.parametrize("propagator", ["sgc", "appnp", "ssgc"])
def test_citation_run_matches_reference(planetoid_root, monkeypatch,
                                        propagator):
    _carry_init(monkeypatch, port_citation, "get_model")
    want = ref_citation.run(RefConfig(dataset="cora"), str(planetoid_root),
                            propagator=propagator)
    got = port_citation.run(CitationConfig(dataset="cora"),
                            str(planetoid_root), propagator=propagator,
                            device=CPU)
    assert set(got) == set(want)
    for k in ("val_accuracy", "test_accuracy"):
        assert got[k] == want[k], k
    assert got["precompute_time"] > 0 and got["train_time"] > 0


def test_citation_run_raises_for_unported_paths(planetoid_root):
    with pytest.raises(NotImplementedError, match="item 13"):
        port_citation.run(CitationConfig(), str(planetoid_root),
                          sharded=True, device=CPU)
    with pytest.raises(NotImplementedError, match="item 11"):
        port_citation.run(CitationConfig(model="GCN"), str(planetoid_root),
                          device=CPU)


def test_citation_main_prints_reference_lines(planetoid_root, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "citation", "--dataset", "citeseer", "--tuned", "--data_path",
        str(planetoid_root), "--device", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        port_citation.main()
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("using tuned weight decay: 2.35")
    assert lines[1].startswith("Validation Accuracy: ")
    assert lines[2].startswith("Pre-compute time: ")


def test_sweep_matches_reference(planetoid_root, monkeypatch):
    _carry_init(monkeypatch, port_sweep, "init_sgc")
    kw = dict(datasets=["cora", "citeseer"], degrees=[1, 3], epochs=50,
              data_path=str(planetoid_root))
    want = ref_sweep.sweep(**kw)
    got = port_sweep.sweep(**kw, device=CPU)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("dataset", "K", "val_acc", "test_acc", "weight_decay"):
            assert g[k] == w[k], (k, g, w)
    out = io.StringIO()
    with redirect_stdout(out):
        port_sweep.print_table(got)
    assert out.getvalue().splitlines()[0].split() == list(got[0])
