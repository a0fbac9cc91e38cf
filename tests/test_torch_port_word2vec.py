"""Skip-gram word2vec of the port (``sgc_tpu_torch/textgraph/word2vec.py``,
``cli/word2vec.py``) against the reference's, on the CPU.

Host work bit for bit: the vocabulary, the counts and the skip-gram
pairs. The step and the fits take the reference's random numbers: its
``uniform(-0.5, 0.5) / dim`` init and each step's ``(B, K)`` uniforms,
rebuilt from its key splits (word2vec.py:157-187) and passed in through
the port's ``init_table`` and ``draw_uniforms``.

Tolerances (relative to max|ref|): one step's tables 1e-6 and its loss
1e-6: the update is kernel B's plain version, which sums each row's
``-lr * grad`` rows first and adds the sum to the table, where XLA adds
them to the table one by one (f32 rounding of a few adds). Whole fits
1e-4: those differences compound over the steps (measured 7.5e-6 after
3 epochs of 128-pair batches).
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.cli import word2vec as ref_cli
from sgc_tpu.textgraph import word2vec as ref

from sgc_tpu_torch.cli import word2vec as port_cli
from sgc_tpu_torch.ops.spmm import scatter_graph, spmm_segment
from sgc_tpu_torch.textgraph import word2vec as port
from sgc_tpu_torch.textgraph.embedding import load_embedding_map

CPU = "cpu"
STEP_TOL = 1e-6
FIT_TOL = 1e-4


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def corpus(n_docs=60, n_words=50, seed=0, length=20):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    return [[words[j] for j in rng.zipf(1.5, int(rng.integers(0, length)))
             % n_words] for _ in range(n_docs)]


@pytest.fixture
def reference_draws(monkeypatch):
    """Make the port draw the reference's numbers for ``cfg``: its init
    from ``k_init`` and one uniform batch per step from the key chain."""

    def install(cfg, n_words):
        key = jax.random.PRNGKey(cfg.seed)
        k_init, key = jax.random.split(key)
        init = np.array(jax.random.uniform(
            k_init, (n_words, cfg.dim), jnp.float32, -0.5, 0.5) / cfg.dim)
        state = {"key": key}

        def draw(generator, b, k):
            state["key"], sub = jax.random.split(state["key"])
            return torch.from_numpy(np.array(jax.random.uniform(sub, (b, k))))

        monkeypatch.setattr(port, "init_table",
                            lambda g, n, d, dev: torch.from_numpy(init))
        monkeypatch.setattr(port, "draw_uniforms", draw)

    return install


def test_vocab_and_pairs_bit_for_bit():
    docs = corpus(40, 30, 1) + [[], ["w1"]]
    for min_count in (1, 3):
        got, want = port.build_vocab(docs, min_count), \
            ref.build_vocab(docs, min_count)
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        for window in (1, 5):
            p, r = (port.skipgram_pairs(docs, got[1], window),
                    ref.skipgram_pairs(docs, want[1], window))
            assert p.dtype == r.dtype
            np.testing.assert_array_equal(p, r)
    assert port.skipgram_pairs([["a"]], {"a": 0}, 2).shape == (0, 2)


def test_scatter_graph_is_the_reference_scatter_add():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((12, 5)).astype(np.float32)
    ids = rng.integers(0, 12, 40)
    rows = rng.standard_normal((40, 5)).astype(np.float32)
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(ids)].add(
        -0.025 * jnp.asarray(rows)))
    g = scatter_graph(torch.from_numpy(ids), 12, -0.025)
    assert g.row_ptr.dtype == torch.int32 and int(g.row_ptr[-1]) == 40
    # each row lists its positions in increasing order
    assert torch.equal(g.cols.long(), torch.from_numpy(
        np.argsort(ids, kind="stable")))
    got = spmm_segment(g, torch.from_numpy(rows), dense=torch.from_numpy(
        table))
    assert rel_err(got.numpy(), want) <= STEP_TOL


def test_step_matches_reference():
    rng = np.random.default_rng(4)
    v, d, b, k = 30, 8, 64, 5
    in_emb = (rng.random((v, d), np.float32) - 0.5) / d
    out_emb = rng.standard_normal((v, d)).astype(np.float32) * 0.1
    centers = rng.integers(0, v, b).astype(np.int32)
    contexts = rng.integers(0, v, b).astype(np.int32)
    freq = rng.integers(1, 50, v).astype(np.float64)
    noise = freq ** 0.75
    cdf = jnp.asarray(np.cumsum(noise / noise.sum()), jnp.float32)
    key = jax.random.PRNGKey(5)
    (want_in, want_out), want_loss = ref._sgns_step(
        (jnp.asarray(in_emb), jnp.asarray(out_emb)), jnp.asarray(centers),
        jnp.asarray(contexts), key, cdf, k, 0.025)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (b, k))))
    got_in, got_out, got_loss = port.sgns_step(
        torch.from_numpy(in_emb), torch.from_numpy(out_emb),
        torch.from_numpy(centers), torch.from_numpy(contexts), u,
        port.noise_cdf(freq, CPU), 0.025)
    np.testing.assert_array_equal(port.noise_cdf(freq, CPU).numpy(),
                                  np.asarray(cdf))
    assert rel_err(got_in.numpy(), want_in) <= STEP_TOL
    assert rel_err(got_out.numpy(), want_out) <= STEP_TOL
    assert abs(float(got_loss) - float(want_loss)) <= STEP_TOL * abs(
        float(want_loss))


@pytest.mark.parametrize("warm", [False, True])
def test_fit_matches_reference(reference_draws, warm):
    docs = corpus()
    cfg = ref.Word2VecConfig(dim=16, window=3, epochs=3, batch_size=128,
                             seed=3)
    init = ({f"w{i}": np.full(16, 0.01 * i, np.float32) for i in range(0, 50,
                                                                       3)}
            if warm else None)
    want = ref.Word2Vec(cfg).train(docs, init_vectors=init)
    reference_draws(cfg, len(want.vocab))
    got = port.Word2Vec(port.Word2VecConfig(**cfg.__dict__),
                        device=CPU).train(docs, init_vectors=init)
    assert got.vocab == want.vocab and got.word_id == want.word_id
    assert rel_err(got.vectors, want.vectors) <= FIT_TOL


def test_two_fits_give_the_same_bits():
    docs = corpus(30, 20, 6)
    cfg = port.Word2VecConfig(dim=8, window=2, epochs=2, batch_size=64)
    a = port.Word2Vec(cfg, device=CPU).train(docs)
    b = port.Word2Vec(cfg, device=CPU).train(docs)
    np.testing.assert_array_equal(a.vectors, b.vectors)


def test_training_brings_cooccurring_words_together():
    rng = np.random.default_rng(0)
    docs = []
    for _ in range(200):
        docs.append(list(rng.permutation(["cat", "dog", "pet"])))
        docs.append(list(rng.permutation(["stock", "bond", "fund"])))
    w2v = port.Word2Vec(port.Word2VecConfig(
        dim=16, window=2, epochs=4, batch_size=512, lr=0.02, seed=1),
        device=CPU).train(docs)
    assert np.all(np.isfinite(w2v.vectors))
    sims = dict(w2v.most_similar("cat", topn=5))
    assert sims["dog"] > sims["stock"]
    assert sims["pet"] > sims["fund"]


def test_queries_exports_and_empty_corpus(tmp_path):
    docs = [["x", "y"], ["y", "z"]]
    w2v = port.Word2Vec(port.Word2VecConfig(dim=8, epochs=1, batch_size=4),
                        device=CPU).train(docs)
    d = w2v.as_dict()
    assert set(d) == {"x", "y", "z"} and d["x"].shape == (8,)
    assert "x" in w2v and "q" not in w2v
    w2v.save_tsv(tmp_path / "w2v.tsv")
    lines = (tmp_path / "w2v.tsv").read_text().strip().split("\n")
    assert len(lines) == 3
    word, vec = lines[0].split("\t")
    assert word == "x" and len(vec.split()) == 8
    # the same neighbours and the same file as the reference's, given the
    # same vectors
    r = ref.Word2Vec(ref.Word2VecConfig(dim=8))
    r.vocab, r.word_id, r.vectors = w2v.vocab, w2v.word_id, w2v.vectors
    assert w2v.most_similar("y", 2) == r.most_similar("y", 2)
    r.save_tsv(tmp_path / "ref.tsv")
    assert (tmp_path / "ref.tsv").read_text() == \
        (tmp_path / "w2v.tsv").read_text()

    empty = port.Word2Vec(port.Word2VecConfig(dim=4), device=CPU).train([])
    assert empty.vectors.shape == (0, 4)
    assert empty.most_similar("anything") == []
    one = port.Word2Vec(port.Word2VecConfig(dim=4), device=CPU).train([["a"]])
    np.testing.assert_array_equal(one.vectors, np.zeros((1, 4), np.float32))


def test_pretrained_init_and_finetune():
    """The reference's warm-start cases: epochs=0 keeps the pretrained
    vector; after training, seeded words end closer to their start than
    fresh ones."""
    pre = {"cat": np.full(8, 0.5, np.float32)}
    w2v = port.Word2Vec(port.Word2VecConfig(dim=8, epochs=0, batch_size=4),
                        device=CPU).train([["cat", "dog"]] * 5,
                                          init_vectors=pre)
    np.testing.assert_allclose(w2v["cat"], pre["cat"])
    assert not np.allclose(w2v["dog"], pre["cat"])

    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(20)]
    docs = [[vocab[rng.integers(0, 20)] for _ in range(12)]
            for _ in range(40)]
    pre = {w: rng.standard_normal(8).astype(np.float32) * 0.1
           for w in vocab[:10]}
    trained = port.Word2Vec(port.Word2VecConfig(
        dim=8, epochs=3, batch_size=16, seed=7), device=CPU).train(
        docs, init_vectors=pre)
    start = port.Word2Vec(port.Word2VecConfig(
        dim=8, epochs=0, batch_size=16, seed=7), device=CPU).train(
        docs, init_vectors=pre)
    moves = {w: float(np.linalg.norm(trained[w] - start[w])) for w in vocab}
    seeded = np.mean([m for w, m in moves.items() if w in pre])
    fresh = np.mean([m for w, m in moves.items() if w not in pre])
    assert 0 < seeded < fresh


def test_cli_matches_reference(tmp_path, monkeypatch, reference_draws,
                               capsys):
    docs = corpus(50, 40, 8)
    path = tmp_path / "c.clean.txt"
    path.write_text("\n".join(" ".join(d) for d in docs) + "\n\n")
    argv = ["word2vec", "--corpus", str(path), "--dim", "8", "--epochs", "2",
            "--batch_size", "64", "--neighbors", "3"]
    monkeypatch.setattr(sys, "argv", argv + ["--out", str(tmp_path / "r")])
    ref_cli.main()
    vocab = sorted({w for d in docs for w in d})
    reference_draws(ref.Word2VecConfig(dim=8, epochs=2, batch_size=64),
                    len(vocab))
    monkeypatch.setattr(sys, "argv", argv + ["--out", str(tmp_path / "p"),
                                             "--device", CPU])
    port_cli.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].replace("/r.", "/p.") == out[1]
    want, got = (load_embedding_map(tmp_path / f"{s}.npz") for s in "rp")
    assert sorted(got) == sorted(want) == vocab
    assert rel_err(np.stack([got[w] for w in vocab]),
                   np.stack([want[w] for w in vocab])) <= FIT_TOL
    assert [l.split("\t")[0] for l in
            (tmp_path / "p.tsv").read_text().splitlines()] == vocab
    nb = (tmp_path / "p.neighbors.txt").read_text().splitlines()
    assert len(nb) == len(vocab) and all(l.count(":") == 3 for l in nb)
