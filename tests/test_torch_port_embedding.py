"""The word embedders of the port (``sgc_tpu_torch/textgraph/embedding.py``,
``cli/embedding.py``) against the reference's, on the CPU.

* ``hash_embedding``, the pooling modes and the hash backend's tables
  and files: bit for bit.
* The ``torch`` backend on a tiny BERT built from a ``BertConfig`` and
  saved to a local directory (no download; ``transformers`` only): the
  port and the reference's torch backend run the same encoder, so the
  pooled vectors agree to f32 rounding (1e-6 of max). The reference's
  backend switches grad mode off for the whole process
  (embedding.py:168); the test records that and restores it; the port's
  leaves it on.
* The fallbacks: ``auto`` warns and hashes when no model loads, an
  explicit backend raises, ``flax`` raises naming ``torch``, and a fault
  after the load (moving the model to the device) raises instead of
  hashing.

Every model name here is a local directory, and the HF hub is switched
to offline mode around each test that loads one.
"""

import pickle
import sys

import numpy as np
import pytest
import torch

from sgc_tpu.cli import embedding as ref_cli
from sgc_tpu.textgraph import embedding as ref

from sgc_tpu_torch.cli import embedding as port_cli
from sgc_tpu_torch.textgraph import embedding as port

CPU = "cpu"
TOL = 1e-6


@pytest.fixture
def offline(monkeypatch):
    """No hub access: every load below is from a local directory."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    hub = pytest.importorskip("transformers.utils.hub")
    monkeypatch.setattr(hub, "_is_offline_mode", True, raising=False)
    import huggingface_hub.constants as constants

    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", True)


@pytest.fixture
def tiny_bert(tmp_path, offline):
    """A BertModel and its word-piece tokenizer saved in a directory."""
    from transformers import BertConfig, BertModel, BertTokenizer

    words = ["viral", "protein", "bind", "##ing", "assay", "cell", "##s",
             "immune"]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizer(vocab_file=str(tmp_path / "vocab.txt")).save_pretrained(
        tmp_path)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        BertModel(BertConfig(
            vocab_size=len(vocab), hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=16)).save_pretrained(tmp_path)
    return str(tmp_path)


def test_hash_embedding_and_pooling_bit_for_bit():
    for word in ("protein", "proteins", "", "sars-cov-2"):
        for dim in (8, 64):
            np.testing.assert_array_equal(port.hash_embedding(word, dim),
                                          ref.hash_embedding(word, dim))
    a = port.hash_embedding("protein", 32)
    assert np.linalg.norm(a) == pytest.approx(1.0, abs=1e-5)
    toks = np.random.default_rng(0).standard_normal((3, 4)).astype(
        np.float32)
    for mode in port.POOLING_MODES:
        p = port.WordEmbedder(port.EmbedderConfig(pooling=mode,
                                                  backend="hash"))
        r = ref.WordEmbedder(ref.EmbedderConfig(pooling=mode,
                                                backend="hash"))
        np.testing.assert_array_equal(p._pool(toks), r._pool(toks))
    with pytest.raises(ValueError):
        port.WordEmbedder(port.EmbedderConfig(pooling="bogus"))._pool(toks)


def test_hash_backend_tables_and_cli_match(tmp_path, monkeypatch, capsys):
    words = ["alpha", "beta", "gamma"]
    got = port.WordEmbedder(port.EmbedderConfig(
        backend="hash", hash_dim=16)).embed_vocab_to_file(
        words, tmp_path / "v.npz")
    want = ref.WordEmbedder(ref.EmbedderConfig(
        backend="hash", hash_dim=16)).embed_words(words)
    assert list(got) == list(want)
    for w in words:
        np.testing.assert_array_equal(got[w], want[w])
    assert set(port.load_embedding_map(tmp_path / "v.npz")) == set(words)

    vocab_file = tmp_path / "vocab.pkl"
    with open(vocab_file, "wb") as f:
        pickle.dump(["enzyme", "market", "cell"], f)
    text_file = tmp_path / "vocab.txt"
    text_file.write_text("enzyme\n\nmarket\ncell\n")
    for main, name in ((ref_cli.main, "r"), (port_cli.main, "p")):
        for src in (vocab_file, text_file):
            monkeypatch.setattr(sys, "argv", [
                "embedding", "--vocab", str(src), "--backend", "hash",
                "--out", str(tmp_path / f"{name}{src.suffix}.npz")])
            main()
    out = capsys.readouterr().out.splitlines()
    assert out[2:] == [o.replace("/r.", "/p.") for o in out[:2]]
    for suffix in (".pkl", ".txt"):
        a = port.load_embedding_map(tmp_path / f"p{suffix}.npz")
        b = port.load_embedding_map(tmp_path / f"r{suffix}.npz")
        assert list(a) == list(b) == ["enzyme", "market", "cell"]
        for w in a:
            np.testing.assert_array_equal(a[w], b[w])


@pytest.mark.parametrize("pooling", ["mean", "first", "sum"])
def test_torch_backend_matches_reference_and_keeps_grad_mode(tiny_bert,
                                                             pooling):
    words = ["viral", "binding", "cells", "assay", "unknownword", "immune"]
    cfg = dict(model_name=tiny_bert, pooling=pooling, backend="torch",
               batch_size=4, max_length=8)
    got = port.WordEmbedder(port.EmbedderConfig(**cfg),
                            device=CPU).embed_words(words)
    assert torch.is_grad_enabled()
    try:
        want = ref.WordEmbedder(ref.EmbedderConfig(**cfg)).embed_words(words)
        # the reference's fault (ROADMAP queue 3): grad mode is now off
        # for the whole process
        assert not torch.is_grad_enabled()
    finally:
        torch.set_grad_enabled(True)
    assert list(got) == list(want) == words
    for w in words:
        assert got[w].shape == (16,)
        err = float(np.abs(got[w] - want[w]).max())
        assert err <= TOL * max(float(np.abs(want[w]).max()), 1e-30), w


def test_auto_warns_then_hashes(tmp_path, offline):
    emb = port.WordEmbedder(port.EmbedderConfig(
        backend="auto", model_name=str(tmp_path), hash_dim=8), device=CPU)
    with pytest.warns(UserWarning, match="hash"):
        table = emb.embed_words(["word"])
    np.testing.assert_array_equal(table["word"],
                                  port.hash_embedding("word", 8))


def test_explicit_backend_failure_raises(tmp_path, offline):
    emb = port.WordEmbedder(port.EmbedderConfig(
        backend="torch", model_name=str(tmp_path)), device=CPU)
    with pytest.raises(RuntimeError, match="failed to load"):
        emb.embed_words(["word"])


def test_flax_backend_raises_naming_torch():
    emb = port.WordEmbedder(port.EmbedderConfig(backend="flax"), device=CPU)
    with pytest.raises(ValueError, match="torch"):
        emb.embed_words(["word"])


def test_a_fault_after_the_load_is_not_hashed(tiny_bert, monkeypatch):
    """Only load errors fall back: a failure placing the model on the
    device (a fault of the card) raises, under ``auto`` too."""
    def broken_to(self, *a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    from transformers import BertModel

    monkeypatch.setattr(BertModel, "to", broken_to)
    emb = port.WordEmbedder(port.EmbedderConfig(
        backend="auto", model_name=tiny_bert), device=CPU)
    with pytest.raises(RuntimeError, match="illegal memory"):
        emb.embed_words(["viral"])
