"""The text CLIs of the port against the reference, on the CPU: the
TextSGC trainer (``cli.textsgc.run``), the feature cache of
``--preprocessed``, the cross-validation runner, the results scorer and
the text family of the tuner.

Both packages read the same exported corpus (``write_text_corpus``, 200
docs, 4 classes) and start from the same head: the reference's
``init_sgc(PRNGKey(seed), bias=False, init="xavier_normal")`` carried
over by ``params_from_jax`` (the packages' random streams differ). The
structural features agree to 1e-5 of max|ref| (f32 summation order,
tests/test_torch_port_text.py); the fitted heads to 1e-4 of max|w| for
LBFGS (the 5e-4 loss bound of tests/test_lbfgs_torch_oracle.py is for a
harder problem; here three epochs of 20 iterations from one init) and
for the Newton fit at weight decay 1e-2; the accuracies are equal.

The Newton fit solves with the factor of ``Z'Z/n + wd I``; with 500
features over 144 train docs Z'Z is singular, so at a small weight decay
the factor amplifies the f32 rounding of the two packages' Gram
matrices: on identical features the heads differ by 2.2e-3 of max|w| at
wd 1e-3 and by 3.8e-7 at wd 1e-2. The run test holds the accuracies at
1e-3; the head test compares the heads at 1e-2.
"""

import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax

from sgc_tpu.cli import crossval as ref_crossval
from sgc_tpu.cli import score_results as ref_score
from sgc_tpu.cli import textsgc as ref_textsgc
from sgc_tpu.cli import tuning as ref_tuning
from sgc_tpu.cli.build_graph import build_and_export as ref_build
from sgc_tpu.data.crossval import make_crossval_ids as ref_crossval_ids
from sgc_tpu.models.sgc import init_sgc as ref_init
from sgc_tpu.utils.config import TextConfig as RefTextConfig

from sgc_tpu_torch.cli import crossval as port_crossval
from sgc_tpu_torch.cli import score_results as port_score
from sgc_tpu_torch.cli import textsgc as port_textsgc
from sgc_tpu_torch.cli import tuning as port_tuning
from sgc_tpu_torch.cli.build_graph import build_and_export
from sgc_tpu_torch.data.crossval import make_crossval_ids
from sgc_tpu_torch.data.fixtures import write_text_corpus
from sgc_tpu_torch.models.sgc import params_from_jax
from sgc_tpu_torch.utils.config import TextConfig

CPU = "cpu"
HEAD_TOL = 1e-4
SMALL = dict(n_train=160, n_test=40, n_classes=4, vocab=300, doc_len=30.0,
             topic=0.5, topic_words=30)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """One exported corpus (both packages export the same bytes) with
    two cross-validation folds."""
    root = tmp_path_factory.mktemp("textcli")
    info = write_text_corpus(root, "tiny", seed=3, **SMALL)
    build_and_export(str(info["metadata"]), str(info["corpus"]), "tiny",
                     str(root), window=10, val_fraction=0.1)
    make_crossval_ids(info["metadata"], root, "tiny", n_folds=2)
    return root


@pytest.fixture
def carried_init(monkeypatch):
    """The port's inits replaced by the reference's, carried over."""
    def init(generator, nfeat, nclass, bias=True, init="torch",
             device=None):
        p = ref_init(jax.random.PRNGKey(42), nfeat, nclass, bias=bias,
                     init=init)
        return params_from_jax(np.asarray(p.w),
                               None if p.b is None else np.asarray(p.b),
                               device=device)
    monkeypatch.setattr(port_textsgc, "init_sgc", init)
    monkeypatch.setattr(port_tuning, "init_sgc", init)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("trainer,class_weights,wd", [
    ("lbfgs", False, 0.0), ("lbfgs", True, 1e-3), ("newton", False, 1e-3)])
def test_textsgc_run_matches_reference(data_root, carried_init, trainer,
                                       class_weights, wd):
    kw = dict(subset="BCD", data_path=str(data_root), trainer=trainer,
              class_weights=class_weights, impl="sparse")
    want = ref_textsgc.run(RefTextConfig(dataset="tiny", weight_decay=wd),
                           **kw)
    got = port_textsgc.run(TextConfig(dataset="tiny", weight_decay=wd),
                           **kw, device=CPU)
    for key in ("train_accuracy", "val_accuracy", "test_accuracy"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["predictions"],
                                  np.asarray(want["predictions"]))
    np.testing.assert_array_equal(got["test_labels"], want["test_labels"])
    assert got["test_accuracy"] > 2 / SMALL["n_classes"]
    assert got["impl"] == "sparse" and got["precompute_time"] > 0


def test_textsgc_head_matches_reference(data_root, carried_init,
                                        monkeypatch):
    """The fitted head itself (the run returns the port's; the
    reference's is caught at its ``eval_linear``)."""
    seen = {}
    real_eval = ref_textsgc.eval_linear

    def spy(params, *a, **k):
        seen["w"] = np.asarray(params.w)
        return real_eval(params, *a, **k)
    monkeypatch.setattr(ref_textsgc, "eval_linear", spy)
    for trainer, wd in (("lbfgs", 1e-3), ("newton", 1e-2)):
        kw = dict(subset="BCD", data_path=str(data_root), trainer=trainer)
        ref_textsgc.run(RefTextConfig(dataset="tiny", weight_decay=wd),
                        **kw)
        got = port_textsgc.run(TextConfig(dataset="tiny", weight_decay=wd),
                               **kw, device=CPU)
        assert _rel(got["params"].w.numpy(), seen["w"]) <= HEAD_TOL, trainer


def test_textsgc_feature_cache_round_trips(data_root, tmp_path,
                                           carried_init):
    cache = str(tmp_path / "feats.pkl")     # suffixless: .npz appended
    kw = dict(subset="BCD", data_path=str(data_root), feat_cache=cache,
              device=CPU)
    first = port_textsgc.run(TextConfig(dataset="tiny"), **kw)
    assert (tmp_path / "feats.pkl.npz").exists()
    again = port_textsgc.run(TextConfig(dataset="tiny", preprocessed=True),
                             **kw)
    assert again["impl"] == "cache" and again["precompute_time"] == 0.0
    for key in ("train_accuracy", "val_accuracy", "test_accuracy"):
        assert again[key] == first[key]
    torch.testing.assert_close(again["params"].w, first["params"].w,
                               rtol=0, atol=0)
    # the reference reads the port's cache as its own, and the features
    # it caches itself agree with the port's
    want = ref_textsgc.run(
        RefTextConfig(dataset="tiny", preprocessed=True),
        subset="BCD", data_path=str(data_root), feat_cache=cache)
    assert want["test_accuracy"] == again["test_accuracy"]
    ref_cache = str(tmp_path / "ref_feats.npz")
    ref_textsgc.run(RefTextConfig(dataset="tiny"), subset="BCD",
                    data_path=str(data_root), feat_cache=ref_cache)
    with np.load(ref_cache) as r, np.load(cache + ".npz") as p:
        assert sorted(r.files) == sorted(p.files) == ["test", "train",
                                                      "val"]
        for phase in r.files:
            assert _rel(p[phase], r[phase]) <= 1e-5, phase
    with pytest.raises(ValueError, match="feat_cache"):
        port_textsgc.run(TextConfig(dataset="tiny", preprocessed=True),
                         data_path=str(data_root), device=CPU)


def test_textsgc_main_prints_impl(data_root, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "textsgc", "--dataset", "tiny", "--data_path", str(data_root),
        "--impl", "auto", "--device", CPU])
    buf = io.StringIO()
    with redirect_stdout(buf):
        port_textsgc.main()
    lines = buf.getvalue().splitlines()
    assert lines[0] == "impl: dense (asked auto)"
    assert lines[1].startswith("Total Time: ")


def test_crossval_matches_reference(data_root, carried_init, tmp_path):
    kw = dict(folds=2, epochs=2, data_path=str(data_root),
              per_fold_tuned={1: 1e-3})
    want = ref_crossval.run_crossval("tiny", **kw,
                                     results_dir=str(tmp_path / "ref"))
    got = port_crossval.run_crossval("tiny", **kw,
                                     results_dir=str(tmp_path / "port"),
                                     device=CPU)
    for key in ("accuracy_mean", "accuracy_std", "f1_weighted_mean",
                "op_mean"):
        assert got[key] == want[key], key
    for fold in range(2):
        name = f"tiny.{fold}.SGC.results.txt"
        assert (tmp_path / "ref" / name).read_text() == \
            (tmp_path / "port" / name).read_text()


def test_score_results_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for k in range(3):
        labels = rng.integers(0, 5, 60)
        preds = np.where(rng.random(60) < 0.6, labels,
                         rng.integers(0, 5, 60))
        path = tmp_path / f"r{k}.results.txt"
        np.savetxt(path, np.concatenate([preds, labels])[:, None], fmt="%d")
        paths.append(str(path))
    assert port_score.score_files(paths) == ref_score.score_files(paths)
    assert port_score.score_file(paths[0]) == ref_score.score_file(paths[0])
    (tmp_path / "odd.txt").write_text("1\n2\n3\n")
    with pytest.raises(ValueError, match="odd length"):
        port_score.score_file(tmp_path / "odd.txt")


def test_tune_text_matches_reference(data_root, carried_init):
    """Four TPE evals (random start-up points, the same for one seed):
    every trial's val accuracy is equal, so the best weight decay is."""
    kw = dict(dataset="tiny", degree=2, epochs=2, max_evals=4, seed=0,
              data_path=str(data_root), subset="BCD", fold=1)
    want = ref_tuning.tune_text(**kw)
    got = port_tuning.tune_text(**kw, device=CPU)
    assert got == want
    assert 1e-6 <= got[0]["weight_decay"] <= 1.0


def test_tuning_main_text_family_writes_fold_file(data_root, tmp_path,
                                                  monkeypatch):
    out = tmp_path / "tuned"
    monkeypatch.setattr(sys, "argv", [
        "tuning", "--family", "text", "--dataset", "tiny", "--fold", "0",
        "--max_evals", "2", "--data_path", str(data_root), "--output",
        str(out), "--device", CPU])
    buf = io.StringIO()
    with redirect_stdout(buf):
        port_tuning.main()
    saved = json.loads((out / "tiny.0.json").read_text())
    assert set(saved) == {"weight_decay", "val_accuracy"}
    assert buf.getvalue().startswith("best weight_decay: ")


def test_crossval_ids_feed_both_loaders(data_root, tmp_path):
    """The fold files the port writes are the reference's, read back."""
    meta = data_root / "tiny.txt"
    want = ref_crossval_ids(meta, tmp_path, "tiny", n_folds=2)
    got = make_crossval_ids(meta, data_root, "tiny", n_folds=2)
    for w, g in zip(want, got):
        assert all(np.array_equal(w[p], g[p]) for p in w)
