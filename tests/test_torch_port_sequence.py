"""The sequence-classifier trainer and CLI of the port
(``sgc_tpu_torch/train/sequence.py``, ``cli/sequence.py``) against the
reference's, on the CPU.

* Host work bit for bit: the vocabulary, the front- and back-padded
  encodings, the padded batch indices and the batch order.
* The clip in optax's form against ``optax.clip_by_global_norm`` (active
  and inactive), to f32 rounding (1e-6 of max).
* Training from the reference's init (``params_from_jax``) with dropout
  off, clip active and inactive, and three steps with dropout on the
  reference's masks (rebuilt from its key splits) against the
  reference's step (its loss, optax's clip and Adam): each parameter's
  l2 distance from the reference's within 2^-5 of its l2 change from
  the start, no element further than Adam's 2 lr a step, the losses
  within 1e-3, the predictions equal. Why not tighter: the gradients
  agree only to the bf16 recipe's bound (tests/test_torch_port_
  transformer.py: an f32 difference that flips a bf16 rounding moves an
  element by 2^-8 of itself), and Adam divides each element by its own
  magnitude, so an element whose gradient sits at the rounding noise can
  take a different step of up to lr. Measured: l2 0.09-0.7% of the
  change, losses within 4.0e-4 (the first step's equal).
* The CLI: the same test accuracy line from the same init.
"""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sgc_tpu.cli import sequence as ref_cli
from sgc_tpu.models import transformer as ref_model
from sgc_tpu.train import sequence as ref

from sgc_tpu_torch.cli import sequence as port_cli
from sgc_tpu_torch.data.fixtures import write_text_corpus
from sgc_tpu_torch.models import transformer as port_model
from sgc_tpu_torch.train import sequence as port

CPU = "cpu"
CHANGE_TOL = 2.0 ** -5
PARAM_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy(n=40, seed=0, length=5):
    rng = np.random.default_rng(seed)
    words = {0: ["aa", "bb", "cc"], 1: ["xx", "yy", "zz"]}
    docs, labels = [], []
    for _ in range(n):
        y = int(rng.integers(0, 2))
        docs.append(list(rng.choice(words[y], int(rng.integers(1, length)))))
        labels.append(y)
    return docs, np.asarray(labels)


def leaves(params):
    yield "tok_emb", params.tok_emb
    yield "pos_emb", params.pos_emb
    for i, p in enumerate(params.layers):
        for k in port_model.LAYER_KEYS:
            yield f"{i}.{k}", getattr(p, k)
    for k in ("ln_f_g", "ln_f_b", "cls_w", "cls_b"):
        yield k, getattr(params, k)


def assert_params_close(model, params, params0, lr, steps):
    """Per parameter: ``|got - want|`` in l2 within ``CHANGE_TOL`` of
    ``|want - start|``, and no element further than Adam's own bound,
    ``2 * lr`` a step."""
    got = {n.replace("layers.", ""): t.detach().numpy()
           for n, t in model.named_parameters()}
    start = dict(leaves(params0))
    for name, want in leaves(params):
        want, w0 = np.asarray(want), np.asarray(start[name])
        change = float(np.linalg.norm(want - w0))
        err = float(np.linalg.norm(got[name] - want))
        assert err <= CHANGE_TOL * change + PARAM_TOL * float(
            np.linalg.norm(want)), (name, err, change)
        assert float(np.abs(got[name] - want).max()) <= 2 * lr * steps, name


def test_encoding_is_bit_for_bit():
    docs, _ = toy(30, 1, 20)
    docs.append([])
    for max_vocab in (4, 50_000):
        assert port.build_seq_vocab(docs, max_vocab) == \
            ref.build_seq_vocab(docs, max_vocab)
    vocab = ref.build_seq_vocab(docs, 5)
    for front in (True, False):
        for got, want in zip(port.encode_batch(docs, vocab, 8, front),
                             ref.encode_batch(docs, vocab, 8, front)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for n in (3, 8):
        for got, want in zip(port.pad_batch_indices(np.arange(n), 8),
                             ref.pad_batch_indices(np.arange(n), 8)):
            np.testing.assert_array_equal(got, want)
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    idx, w = port.epoch_batches(rng_a, 19, 8)
    perm = rng_b.permutation(19)
    for k, s in enumerate(range(0, 19, 8)):
        want_i, want_w = ref.pad_batch_indices(perm[s:s + 8], 8)
        np.testing.assert_array_equal(idx[k], want_i)
        np.testing.assert_array_equal(w[k], want_w)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    params.append(torch.nn.Parameter(torch.zeros(3)))   # no gradient
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = port.clip_by_global_norm_(params, max_norm)
    assert (float(norm) >= max_norm) == (max_norm == 0.5)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert params[-1].grad is None


@pytest.mark.parametrize("grad_clip", [0.05, 1e4])
def test_trainer_matches_reference(grad_clip):
    docs, labels = toy(20, 3)
    cfg = ref_model.TransformerConfig(vocab_size=16, n_classes=2, max_len=6,
                                      dim=16, n_heads=2, n_layers=1)
    tcfg = dict(lr=3e-3, epochs=2, batch_size=8, dropout=0.0,
                grad_clip=grad_clip, seed=5)
    params0 = ref_model.init_transformer(jax.random.PRNGKey(7), cfg)
    want, vocab = ref.train_sequence_classifier(
        docs, labels, cfg, ref.SeqTrainConfig(**tcfg), params=params0)
    model, got_vocab = port.train_sequence_classifier(
        docs, labels, port_model.TransformerConfig(**cfg.__dict__),
        port.SeqTrainConfig(**tcfg),
        params=port_model.params_from_jax(params0, CPU), device=CPU)
    assert got_vocab == vocab
    assert_params_close(model, want, params0, tcfg["lr"], 6)
    np.testing.assert_array_equal(
        port.predict_sequence(model, docs, vocab, 6, batch_size=16),
        ref.predict_sequence(want, docs, vocab, 6, batch_size=16))


def test_steps_with_reference_dropout_masks_match():
    """Three steps of the reference's step (sequence.py:117-138: its loss,
    optax's clip and Adam) with dropout keys against ``train_step`` with
    the masks those keys draw."""
    cfg = ref_model.TransformerConfig(vocab_size=32, n_classes=3, max_len=8,
                                      dim=16, n_heads=2, n_layers=2,
                                      dropout=0.2)
    scfg = port.SeqTrainConfig(lr=3e-3, grad_clip=0.5, dropout=0.2)
    params = ref_model.init_transformer(jax.random.PRNGKey(8), cfg)
    model = port_model.params_from_jax(params, CPU)
    opt = torch.optim.Adam(model.parameters(), lr=scfg.lr)
    tx = optax.chain(optax.clip_by_global_norm(scfg.grad_clip),
                     optax.adam(scfg.lr))
    state = tx.init(params)
    rng = np.random.default_rng(8)
    params0 = params
    for step in range(3):
        ids = rng.integers(0, 32, (6, 8)).astype(np.int32)
        mask = (rng.random((6, 8)) < 0.8).astype(np.float32)
        y = rng.integers(0, 3, 6)
        w = np.array([1, 1, 1, 1, 1, 0], np.float32)
        key = jax.random.PRNGKey(100 + step)

        def loss_fn(p):
            logits = ref_model.transformer_apply(
                p, jnp.asarray(ids), jnp.asarray(mask), dropout_rate=0.2,
                dropout_key=key)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(y))
            return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)

        masks, k = [], key
        for _ in range(2 * cfg.n_layers):
            k, sub = jax.random.split(k)
            masks.append(torch.from_numpy(np.array(
                jax.random.bernoulli(sub, 0.8, (6, 8, cfg.dim)))))
        got = port.train_step(model, opt, torch.from_numpy(ids),
                              torch.from_numpy(mask), torch.from_numpy(y),
                              torch.from_numpy(w), scfg,
                              dropout_masks=masks)
        assert abs(float(got) - float(loss)) <= 1e-3 * abs(float(loss))
    assert_params_close(model, params, params0, scfg.lr, 3)


def test_trainer_learns_toy_task_and_repeats():
    """The reference's separable toy task; two fits from one seed give the
    same bits (dropout masks from the seeded generator)."""
    docs, labels = toy(60, 0, 6)
    cfg = port_model.TransformerConfig(vocab_size=32, n_classes=2, max_len=8,
                                       dim=32, n_heads=2, n_layers=1)
    tcfg = port.SeqTrainConfig(lr=3e-3, epochs=10, batch_size=16,
                               dropout=0.1)
    model, vocab = port.train_sequence_classifier(docs, labels, cfg, tcfg,
                                                  device=CPU)
    again, _ = port.train_sequence_classifier(docs, labels, cfg, tcfg,
                                              device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    preds = port.predict_sequence(model, docs, vocab, cfg.max_len)
    assert float((preds == labels).mean()) > 0.9


def test_cli_matches_reference(tmp_path, monkeypatch):
    fx = write_text_corpus(tmp_path, "cv", n_train=48, n_test=16,
                           n_classes=3, vocab=60, doc_len=10.0, topic=0.5,
                           topic_words=8)
    argv = ["sequence", "--metadata", str(fx["metadata"]), "--corpus",
            str(fx["corpus"]), "--epochs", "2", "--dim", "16", "--heads",
            "2", "--layers", "1", "--max_len", "12", "--lr", "1e-3",
            "--batch_size", "8", "--dropout", "0", "--vocab_size", "40"]
    cfg = ref_model.TransformerConfig(vocab_size=40, n_classes=3, max_len=12,
                                      dim=16, n_heads=2, n_layers=1,
                                      dropout=0.0)
    # the reference draws its init from split(PRNGKey(seed))[1]
    init = ref_model.init_transformer(
        jax.random.split(jax.random.PRNGKey(42))[1], cfg)
    monkeypatch.setattr(port, "init_transformer",
                        lambda c, g, d: port_model.params_from_jax(init, d))
    outs = []
    for main, extra in ((ref_cli.main, []), (port_cli.main,
                                             ["--device", CPU])):
        monkeypatch.setattr(sys, "argv", argv + extra)
        buf = io.StringIO()
        with redirect_stdout(buf):
            main()
        outs.append(buf.getvalue().strip())
    assert outs[0].startswith("Test accuracy") and outs[0] == outs[1]
