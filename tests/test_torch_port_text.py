"""The TextSGC path of the port against the reference, on the CPU.

Both packages get the same corpus, written by
``sgc_tpu_torch.data.fixtures.write_text_corpus`` from a seed (200 docs,
4 classes, 300 words):

* host work, bit for bit: every file ``TextGraphBuilder.export`` writes
  (adjacency, index, label and vocab pickles, vocab and label text) for
  window, pivoted TF-IDF, chi-squared selection and embeddings on and
  off; the port's own chi-squared test against scikit-learn's (p-values
  to rtol 1e-10, the same selected vocabulary); the cross-validation
  fold files, unshuffled and shuffled; the loaded graph's arrays;
* ``text_structural_features``: ``sparse`` and ``dense`` to 1e-5 of
  max|ref| (only the f32 summation order differs); ``blockdense``
  against the reference's own ``blockdense`` (the same bf16 cells and the
  same bf16 rounding of x, f32 sums) to the same 1e-5; also on a graph
  whose train phase is wider than one 2048-column chunk.
"""

import filecmp
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgc_tpu.cli.build_graph import build_and_export as ref_build
from sgc_tpu.data.crossval import make_crossval_ids as ref_crossval_ids
from sgc_tpu.data.textcorpus import load_corpus as ref_load_corpus
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops.propagate import text_structural_features as ref_tsf
from sgc_tpu.textgraph import graph as ref_graph

from sgc_tpu_torch.cli.build_graph import build_and_export as port_build
from sgc_tpu_torch.data.crossval import make_crossval_ids
from sgc_tpu_torch.data.fixtures import write_text_corpus
from sgc_tpu_torch.data.textcorpus import load_corpus
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.ops import propagate as port_prop
from sgc_tpu_torch.textgraph import graph as port_graph
from sgc_tpu_torch.textgraph.embedding import (
    load_embedding_map,
    save_embedding_map,
)

TOL = 1e-5
CPU = "cpu"
SMALL = dict(n_train=160, n_test=40, n_classes=4, vocab=300, doc_len=30.0,
             topic=0.5, topic_words=30)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's parallel workers oversubscribe
    torch's pool, and these runs are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("text")
    info = write_text_corpus(root, "tiny", seed=3, **SMALL)
    return info["metadata"], info["corpus"], root


@pytest.fixture(scope="module")
def embeddings(corpus, tmp_path_factory):
    """An npz map for two thirds of the vocabulary, through the port's
    store."""
    rng = np.random.default_rng(5)
    words = [f"w{i:05d}" for i in range(SMALL["vocab"]) if i % 3]
    path = tmp_path_factory.mktemp("emb") / "emb.npz"
    table = {w: rng.standard_normal(8).astype(np.float32) for w in words}
    save_embedding_map(path, table)
    got = load_embedding_map(path)
    assert set(got) == set(table)
    assert all(np.array_equal(got[w], table[w]) for w in table)
    return str(path)


@pytest.fixture(scope="module")
def exported(corpus, tmp_path_factory):
    """The default build (window 20) by both packages."""
    meta, docs, _ = corpus
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    ref_build(str(meta), str(docs), "tiny", str(ref_dir), val_fraction=0.1)
    port_build(str(meta), str(docs), "tiny", str(port_dir), val_fraction=0.1)
    return ref_dir, port_dir


def _files(d):
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("window,pivoted,p_value,emb", [
    (20, False, None, False),
    (5, True, None, False),
    (20, False, 0.9, False),
    (10, False, None, True),
    (5, True, 0.5, True),
])
def test_builder_exports_match_reference_byte_for_byte(
        corpus, embeddings, tmp_path, window, pivoted, p_value, emb):
    meta, docs, _ = corpus
    kw = dict(window=window, pivoted=pivoted, p_value=p_value,
              embeddings=embeddings if emb else None, val_fraction=0.2,
              seed=7)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = ref_build(str(meta), str(docs), "tiny", str(ref_dir), **kw)
    got = port_build(str(meta), str(docs), "tiny", str(port_dir), **kw)
    names = _files(ref_dir)
    assert names == _files(port_dir) and len(names) == 13
    for name in names:
        assert filecmp.cmp(ref_dir / name, port_dir / name, shallow=False), \
            name
    assert got["vocab"] == want["vocab"]
    if p_value is not None:
        assert len(got["vocab"]) < SMALL["vocab"]


def test_chi2_matches_sklearn(corpus):
    from sklearn.feature_selection import chi2 as sk_chi2

    meta, docs, _ = corpus
    tc = port_graph.TextCorpus.from_files(meta, docs)
    vocab = port_graph.build_vocab(tc.doc_tokens)
    wid = {w: i for i, w in enumerate(vocab)}
    enc = [np.asarray([wid[w] for w in t], np.int64) for t in tc.doc_tokens]
    X = port_graph.tfidf_doc_word(port_graph.doc_word_counts(enc,
                                                             len(vocab)))
    labels = np.asarray([tc.label_names.index(l) for l in tc.labels])
    for cat in range(len(tc.label_names)):
        want_s, want_p = sk_chi2(X, labels == cat)
        got_s, got_p = port_graph.chi2(X, labels == cat)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-10)
        np.testing.assert_allclose(got_p, want_p, rtol=1e-10)
    # a target with one class present: scikit-learn's zero column
    np.testing.assert_allclose(port_graph.chi2(X, labels >= 0)[1],
                               sk_chi2(X, labels >= 0)[1], rtol=1e-10)
    counts = port_graph.doc_word_counts(enc, len(vocab))
    for p_value, cap in ((0.9, 15000), (0.5, 120)):
        np.testing.assert_array_equal(
            port_graph.chi2_select_vocab(counts, labels, p_value, cap),
            ref_graph.chi2_select_vocab(counts, labels, p_value, cap))


@pytest.mark.parametrize("shuffle", [False, True])
def test_crossval_ids_match_reference(corpus, tmp_path, shuffle):
    meta = corpus[0]
    want = ref_crossval_ids(meta, tmp_path / "ref", "tiny", n_folds=3,
                            seed=11, shuffle=shuffle)
    got = make_crossval_ids(meta, tmp_path / "port", "tiny", n_folds=3,
                            seed=11, shuffle=shuffle)
    for w, g in zip(want, got):
        for phase in ("train", "val", "test"):
            np.testing.assert_array_equal(w[phase], g[phase])
    names = _files(tmp_path / "ref")
    assert names == _files(tmp_path / "port") and len(names) == 18
    for name in names:
        assert filecmp.cmp(tmp_path / "ref" / name, tmp_path / "port" / name,
                           shallow=False), name


def test_stratified_folds_match_sklearn():
    from sklearn.model_selection import StratifiedKFold

    from sgc_tpu_torch.data.crossval import stratified_kfold_split

    y = np.random.default_rng(0).integers(0, 5, 97)
    for shuffle, rs in ((False, None), (True, 0), (True, 42)):
        want = StratifiedKFold(4, shuffle=shuffle, random_state=rs).split(
            np.zeros(len(y)), y)
        for (wt, we), (gt, ge) in zip(
                want, stratified_kfold_split(y, 4, shuffle, rs)):
            np.testing.assert_array_equal(wt, gt)
            np.testing.assert_array_equal(we, ge)


def test_load_corpus_matches_reference(exported):
    ref_dir, port_dir = exported
    want = ref_load_corpus("tiny", "BCD", str(ref_dir))
    got = load_corpus("tiny", "BCD", str(port_dir), device=CPU)
    for f in ("rows", "cols", "vals", "row_ptr"):
        np.testing.assert_array_equal(np.asarray(getattr(want.graph, f)),
                                      getattr(got.graph, f).numpy(), f)
    assert got.graph.nnz == want.graph.nnz
    assert (got.n_classes, got.n_nodes) == (want.n_classes, want.n_nodes)
    for p in ("train", "val", "test"):
        np.testing.assert_array_equal(want.index_dict[p], got.index_dict[p])
        np.testing.assert_array_equal(want.label_dict[p], got.label_dict[p])


# ------------------------------------------------ structural features


def _both_features(ref_graph_, port_graph_, idx, impl):
    want, _ = ref_tsf(ref_graph_, idx, degree=2, impl=impl)
    got, secs = port_prop.text_structural_features(port_graph_, idx,
                                                   degree=2, impl=impl)
    assert secs > 0
    return want, got


@pytest.mark.parametrize("impl", ["sparse", "dense", "blockdense", "auto"])
def test_structural_features_match_reference(exported, impl):
    from sgc_tpu_torch.utils.buildcache import clear_placed

    ref_dir, port_dir = exported
    ref = ref_load_corpus("tiny", "BCD", str(ref_dir))
    port = load_corpus("tiny", "BCD", str(port_dir), device=CPU)
    want, got = _both_features(ref.graph, port.graph, port.index_dict, impl)
    clear_placed()
    for p in ("train", "val", "test"):
        assert rel_err(got[p].numpy(), want[p]) <= TOL, p
    assert port_prop.text_impl(port.graph, impl) == (
        "dense" if impl == "auto" else impl)


@pytest.fixture(scope="module")
def wide_graph():
    """The reference's wide-phase graph: 2,600 nodes, 1% density, a
    2,200-doc train phase (two column chunks)."""
    a = sp.random(2600, 2600, density=0.01, random_state=1, format="coo")
    a = (a + a.T).tocoo()
    idx = {"train": np.arange(2200), "val": np.arange(2200, 2400),
           "test": np.arange(2400, 2600)}
    return (RefGraph.from_scipy(a), PortGraph.from_scipy(a).to(CPU), idx)


@pytest.mark.parametrize("impl", ["sparse", "dense", "blockdense"])
def test_structural_features_wide_phase_match_reference(wide_graph, impl):
    from sgc_tpu_torch.utils.buildcache import clear_placed

    rg, pg, idx = wide_graph
    want, got = _both_features(rg, pg, idx, impl)
    clear_placed()
    assert got["train"].shape[0] == 2200
    for p in idx:
        assert rel_err(got[p].numpy(), want[p]) <= TOL, p


def test_structural_features_blockdense_split_admits_cells(wide_graph):
    """The wide graph's split at the text width (2048 features) has dense
    cells and no remainder-free shortcut: kernel A's term is exercised."""
    from sgc_tpu.ops.spmm_blockdense import split_block_dense as ref_split

    from sgc_tpu_torch.ops.spmm_blockdense import split_block_dense

    rg, pg, _ = wide_graph
    want, got = ref_split(rg, 2048), split_block_dense(pg, 2048)
    assert got.n_cells == want.n_cells > 0
    assert (got.dense_edges, got.sparse_edges) == (want.dense_edges,
                                                   want.sparse_edges)
    np.testing.assert_array_equal(got.cells, want.cells.view(np.uint16))


def test_onehot_selector_and_slice():
    rg = RefGraph.from_scipy(sp.random(50, 50, density=0.2, random_state=2))
    pg = PortGraph.from_scipy(sp.random(50, 50, density=0.2, random_state=2))
    idx = np.array([3, 7, 0, 49])
    from sgc_tpu.ops.propagate import _sliced_columns, onehot_selector

    np.testing.assert_array_equal(port_prop.onehot_selector(50, idx,
                                                            CPU).numpy(),
                                  np.asarray(onehot_selector(50, idx)))
    np.testing.assert_array_equal(port_prop._sliced_columns(pg, idx),
                                  np.asarray(_sliced_columns(rg, idx)))
    with pytest.raises(ValueError, match="place the graph"):
        port_prop.text_structural_features(pg, {"train": idx})


def test_adjacency_pickles_load_as_scipy(exported):
    _, port_dir = exported
    with open(port_dir / "ind.tiny.BCD.adj", "rb") as f:
        adj = pickle.load(f)
    assert sp.isspmatrix_csr(adj)
    assert adj.shape[0] == 200 + SMALL["vocab"]
