"""The port's Reddit path against the reference on the same files: the
loader, the linear-head trainers (``train_linear`` by Newton and by the
LBFGS oracle, ``eval_linear``), and ``cli.reddit.run`` on the plain path
(inductive and transductive) and with ``locality``.

Inputs: ``tests/test_reddit_fixture.py``'s ``_write_fixture`` (the real
export's file names, keys and dtypes) for the loader, and
``sgc_tpu_torch.data.fixtures.write_reddit`` at scale 0.01 (2,329 nodes,
clustered recipe) for the CLI. Tolerances:

* the loader's graphs, labels and splits: exact; the standardized
  features: 1e-6 relative (column sums in another order);
* the locality path's eval features against the plain path's: 1e-2
  relative to max, since on the CPU its split stores cells in bf16;
* the Newton head: 1e-4 relative, its loss 1e-4; the LBFGS oracle's loss
  5e-4 at wd 1e-2 (at small weight decays both LBFGS runs diverge), the
  bounds ``test_torch_port_slice.py`` uses;
* CLI F1: equal, from the reference's init carried over with
  ``params_from_jax``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.cli import reddit as ref_reddit
from sgc_tpu.data.reddit import load_reddit as ref_load
from sgc_tpu.models.sgc import init_sgc as ref_init
from sgc_tpu.train import loops as ref_loops

from sgc_tpu_torch.cli import reddit as port_reddit
from sgc_tpu_torch.data.fixtures import REDDIT_SPLIT, write_reddit
from sgc_tpu_torch.data.reddit import load_reddit
from sgc_tpu_torch.models.sgc import params_from_jax
from sgc_tpu_torch.train import loops as port_loops

from test_reddit_fixture import _write_fixture

CPU = "cpu"


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("reddit_small")
    _write_fixture(root)
    return root


@pytest.fixture(scope="module")
def clustered_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("reddit_clustered")
    counts = write_reddit(root, scale=0.01, seed=3)
    return root, counts


def test_load_reddit_matches_reference(small_root):
    want = ref_load("AugNormAdj", data_path=str(small_root))
    got = load_reddit("AugNormAdj", data_path=str(small_root), device=CPU)
    for g, w in ((got.graph, want.graph), (got.train_graph,
                                           want.train_graph)):
        assert (g.nnz, g.shape) == (w.nnz, w.shape)
        for a in ("rows", "cols", "vals", "row_ptr"):
            np.testing.assert_array_equal(getattr(g, a).numpy(),
                                          np.asarray(getattr(w, a)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for a in ("idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    assert got.n_classes == want.n_classes == 3
    assert rel_err(got.features.numpy(), want.features) <= 1e-6


def test_write_reddit_shape_and_reference_loader(clustered_root):
    root, counts = clustered_root
    n = counts["nodes"]
    assert n == 2329 and counts["features"] == 602
    assert counts["classes"] == 41
    frac = n / 232_965
    assert (counts["train"], counts["val"], counts["test"]) == tuple(
        int(round(k * frac)) for k in REDDIT_SPLIT)
    want = ref_load("AugNormAdj", data_path=str(root))
    got = load_reddit("AugNormAdj", data_path=str(root), device=CPU)
    np.testing.assert_array_equal(got.graph.vals.numpy(),
                                  np.asarray(want.graph.vals))
    np.testing.assert_array_equal(got.idx_test, want.idx_test)
    assert len(got.idx_train) == counts["train"]
    # the three splits are disjoint
    assert len(np.unique(np.concatenate(
        [got.idx_train, got.idx_val, got.idx_test]))) == sum(
            (counts["train"], counts["val"], counts["test"]))


# ------------------------------------------------------------- the head


@pytest.fixture(scope="module")
def linear_problem():
    rng = np.random.default_rng(5)
    n, f, c = 600, 40, 6
    y = rng.integers(0, c, n).astype(np.int32)
    # overlapping classes, so the fitted loss stays far from 0
    x = (0.3 * rng.standard_normal((c, f))[y]
         + rng.standard_normal((n, f))).astype(np.float32)
    p0 = ref_init(jax.random.PRNGKey(42), f, c)
    return x, y, p0


def _port_head(p0):
    return params_from_jax(np.asarray(p0.w), np.asarray(p0.b), device=CPU)


@pytest.mark.parametrize("trainer,wd", [("newton", 0.0), ("newton", 1e-3),
                                        ("lbfgs", 1e-2)])
def test_train_linear_matches_reference(linear_problem, trainer, wd):
    x, y, p0 = linear_problem
    want, _ = ref_loops.train_linear(p0, jnp.asarray(x), jnp.asarray(y),
                                     weight_decay=wd, epochs=2,
                                     trainer=trainer)
    got, seconds = port_loops.train_linear(
        _port_head(p0), torch.from_numpy(x), torch.from_numpy(y),
        weight_decay=wd, epochs=2, trainer=trainer)
    assert seconds > 0 and not got.w.requires_grad
    if trainer == "newton":
        assert rel_err(got.w.numpy(), want.w) <= 1e-4
        assert rel_err(got.b.numpy(), want.b) <= 1e-4
    ref_eval = ref_loops.eval_linear(want, jnp.asarray(x), jnp.asarray(y))
    port_eval = port_loops.eval_linear(got, torch.from_numpy(x),
                                       torch.from_numpy(y))
    assert abs(port_eval["loss"] - ref_eval["loss"]) <= (
        5e-4 if trainer == "lbfgs" else 1e-4) * abs(ref_eval["loss"])
    assert abs(port_eval["accuracy"] - ref_eval["accuracy"]) <= 2 / len(y)
    with pytest.raises(ValueError, match="trainer"):
        port_loops.train_linear(_port_head(p0), torch.from_numpy(x),
                                torch.from_numpy(y), trainer="adam")


@pytest.mark.parametrize("binary", [False, True])
def test_eval_linear_matches_reference(linear_problem, binary):
    x, y, _ = linear_problem
    c = 1 if binary else int(y.max()) + 1
    yb = (y % 2).astype(np.int32) if binary else y
    p = ref_init(jax.random.PRNGKey(3), x.shape[1], c)
    want = ref_loops.eval_linear(p, jnp.asarray(x), jnp.asarray(yb), binary)
    got = port_loops.eval_linear(_port_head(p), torch.from_numpy(x),
                                 torch.from_numpy(yb), binary)
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(want["predictions"]))


# ------------------------------------------------------------------ CLI


@pytest.fixture
def carried_init(monkeypatch):
    def init(generator, nfeat, nclass, bias=True, device=None, **kw):
        p = ref_init(jax.random.PRNGKey(42), nfeat, nclass, bias=bias)
        return params_from_jax(np.asarray(p.w), np.asarray(p.b),
                               device=device)
    monkeypatch.setattr(port_reddit, "init_sgc", init)


@pytest.mark.parametrize("inductive,locality,trainer,wd", [
    (True, False, "newton", 0.0), (False, False, "newton", 0.0),
    (True, True, "newton", 0.0), (False, True, "newton", 0.0),
    (True, False, "lbfgs", 1e-2)])
def test_reddit_run_matches_reference(clustered_root, carried_init,
                                      inductive, locality, trainer, wd):
    root, _ = clustered_root
    kw = dict(inductive=inductive, test=True, degree=2, epochs=2,
              weight_decay=wd, data_path=str(root), locality=locality,
              trainer=trainer)
    want = ref_reddit.run(**kw)
    got = port_reddit.run(**kw, device=CPU)
    assert set(want) <= set(got)
    assert got["f1_micro"] == want["f1_micro"]
    assert got["f1_macro"] == want["f1_macro"]
    assert got["f1_micro"] > 5 / 41
    assert got["load_time"] > 0 and got["precompute_time"] > 0
    assert ("dense_frac" in got) == locality


def test_reddit_locality_features_match_plain_path(clustered_root):
    root, _ = clustered_root
    kw = dict(inductive=True, test=True, data_path=str(root), device=CPU)
    plain = port_reddit.run(**kw)
    loc = port_reddit.run(**kw, locality=True)
    # on the CPU calibrate=True keeps the committed admission, which
    # admits cells: their bf16 values round the operator, so the rows
    # agree to bf16 rounding (2**-8), not to f32
    assert loc["dense_frac"] > 0.5
    assert rel_err(loc["eval_features"].numpy(),
                   plain["eval_features"].numpy()) <= 1e-2
    assert abs(loc["f1_micro"] - plain["f1_micro"]) < 5e-3


def test_reddit_run_raises_for_unported_paths(clustered_root):
    root, _ = clustered_root
    with pytest.raises(NotImplementedError, match="item 8"):
        port_reddit.run(data_path=str(root), sharded=True, device=CPU)
    with pytest.raises(NotImplementedError, match="item 8"):
        port_reddit.run(data_path=str(root), formulation="segment",
                        device=CPU)
