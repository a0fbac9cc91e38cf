"""The port's weight-decay tuner (tune/tpe.py, cli/tuning.py) against
the reference, and the Adam trainers' warm step.

* TPE: pure numpy, so the same seed and the same objective values give
  the same suggestions, bit for bit.
* ``tune_citation``: from the reference's init carried over with
  ``params_from_jax`` (the packages' random streams differ), the grid's
  per-candidate val accuracies, the best weight decay and the TPE
  search's best are equal. The heads themselves agree to the Adam bound
  of tests/test_torch_port_citation.py (rtol 2e-4, atol 2e-5), which
  leaves every val prediction on this fixture unchanged.
* The warm step the trainers take before their timer works on a
  throwaway copy: the returned heads are the bits of the plain loop.
"""

import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.cli import tuning as ref_tuning
from sgc_tpu.models.sgc import init_sgc as ref_init
from sgc_tpu.models.sgc import sgc_apply as ref_apply
from sgc_tpu.tune import tpe as ref_tpe

from sgc_tpu_torch.cli import tuning as port_tuning
from sgc_tpu_torch.data.fixtures import write_planetoid
from sgc_tpu_torch.models.sgc import SGC, params_from_jax
from sgc_tpu_torch.train import loops as port_loops
from sgc_tpu_torch.tune import tpe as port_tpe

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small problems: when the suite runs
    in parallel workers, torch's thread pool is oversubscribed and its
    many short ops run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(mod):
    return {"wd": mod.loguniform(1e-10, 1e-4), "u": mod.uniform(-2.0, 3.0),
            "c": mod.choice("a", "b", "c")}


def _objective(p):
    """A deterministic loss with ties (the choice) and a smooth part."""
    return ((np.log(p["wd"]) + 15.0) ** 2 + (p["u"] - 1.0) ** 2
            + {"a": 0.5, "b": 0.0, "c": 0.5}[p["c"]])


@pytest.mark.parametrize("seed", [0, 42])
def test_tpe_suggests_the_reference_points_bit_for_bit(seed):
    want = ref_tpe.TPESampler(_space(ref_tpe), seed=seed)
    got = port_tpe.TPESampler(_space(port_tpe), seed=seed)
    for _ in range(40):          # 20 random startup points, then TPE
        pw, pg = want.suggest(), got.suggest()
        assert pg == pw          # floats compared exactly
        want.observe(pw, _objective(pw))
        got.observe(pg, _objective(pg))
    assert got.best == want.best
    best_w = ref_tpe.fmin(_objective, _space(ref_tpe), max_evals=30,
                          seed=seed)
    best_g = port_tpe.fmin(_objective, _space(port_tpe), max_evals=30,
                           seed=seed)
    assert best_g == best_w


@pytest.fixture(scope="module")
def planetoid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("planetoid_tuning")
    write_planetoid(root, "cora", 900, 3000, 60, 4, 28, 200, seed=5)
    return root


@pytest.fixture
def carried_init(monkeypatch):
    """The port's tuner starts from the reference's ``init_sgc(
    PRNGKey(42))``."""
    def init(generator, nfeat, nclass, device=None, **kw):
        p = ref_init(jax.random.PRNGKey(42), nfeat, nclass)
        return params_from_jax(np.asarray(p.w), np.asarray(p.b),
                               device=device)
    monkeypatch.setattr(port_tuning, "init_sgc", init)


def _ref_grid_accuracies(root, grid):
    """The reference's per-candidate val accuracies, by its own steps
    (tune_citation returns the best alone)."""
    from sgc_tpu.data.planetoid import load_citation
    from sgc_tpu.ops.propagate import sgc_precompute
    from sgc_tpu.train.loops import train_regression_many

    data = load_citation("cora", "AugNormAdj", str(root))
    idx = np.concatenate([data.idx_train, data.idx_val])
    feats, _ = sgc_precompute(data.features, data.graph, 2, out_rows=idx)
    n_tr = len(data.idx_train)
    many, _, _ = train_regression_many(
        ref_init(jax.random.PRNGKey(42), feats.shape[1], data.n_classes),
        feats[:n_tr], data.labels[data.idx_train], np.logspace(-10, -4,
                                                               grid),
        epochs=100, lr=0.2)
    logits = jax.vmap(ref_apply, in_axes=(0, None))(many, feats[n_tr:])
    preds = jnp.argmax(logits, axis=-1)
    return np.asarray((preds == data.labels[data.idx_val][None, :]).mean(
        axis=1))


def test_tune_citation_grid_matches_reference(planetoid_root, carried_init,
                                              monkeypatch):
    grid = 6
    want_accs = _ref_grid_accuracies(planetoid_root, grid)
    seen = {}
    real = port_tuning.grid_accuracies

    def spy(heads, val_x, val_y):
        seen["accs"] = real(heads, val_x, val_y)
        return seen["accs"]

    monkeypatch.setattr(port_tuning, "grid_accuracies", spy)
    kw = dict(dataset="cora", degree=2, epochs=100, lr=0.2, max_evals=0,
              seed=42, data_path=str(planetoid_root), grid=grid)
    want = ref_tuning.tune_citation(**kw)
    got = port_tuning.tune_citation(**kw, device=CPU)
    np.testing.assert_array_equal(seen["accs"], want_accs)
    assert got == want
    with pytest.raises(ValueError, match="--grid 1"):
        port_tuning.tune_citation(**{**kw, "grid": 1}, device=CPU)


def test_tune_citation_tpe_matches_reference(planetoid_root, carried_init):
    kw = dict(dataset="cora", degree=2, epochs=60, lr=0.2, max_evals=24,
              seed=42, data_path=str(planetoid_root))
    want = ref_tuning.tune_citation(**kw)
    got = port_tuning.tune_citation(**kw, device=CPU)
    assert got == want


def test_tuning_main_writes_the_reference_file(planetoid_root, tmp_path,
                                               monkeypatch):
    out = tmp_path / "tuned"
    monkeypatch.setattr(sys, "argv", [
        "tuning", "--dataset", "cora", "--grid", "4",
        "--data_path", str(planetoid_root), "--output", str(out),
        "--device", "cpu"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        port_tuning.main()
    saved = json.loads((out / "cora.json").read_text())
    assert set(saved) == {"weight_decay", "val_accuracy"}
    assert buf.getvalue().startswith("best weight_decay: ")
    # the text family runs TPE only (its LBFGS fit is not batched)
    monkeypatch.setattr(sys, "argv", ["tuning", "--family", "text",
                                      "--grid", "4"])
    with pytest.raises(SystemExit, match="citation-family only"):
        port_tuning.main()


# ---------------------------------------------------- the warm Adam step


def _plain_adam(model, x, y, epochs, wd, lr):
    """The trainers' loop without a warm step."""
    fit = SGC(model.w.detach().clone(), model.b.detach().clone())
    opt = torch.optim.Adam(list(fit.parameters()), lr=lr, weight_decay=wd)
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(fit(x), y.long()).backward()
        opt.step()
    return fit


def test_warm_step_leaves_the_heads_bit_identical():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((80, 30), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 4, 80))
    model = params_from_jax(rng.standard_normal((30, 4)) * 0.1,
                            rng.standard_normal(4) * 0.1, device=CPU)
    got, _ = port_loops.train_regression(model, x, y, 40, 1e-3, 0.2)
    want = _plain_adam(model, x, y, 40, 1e-3, 0.2)
    assert torch.equal(got.w, want.w) and torch.equal(got.b, want.b)
    heads, _, _ = port_loops.train_regression_many(model, x, y, [1e-3], 40,
                                                   0.2)
    assert torch.equal(heads[0].w, want.w)
