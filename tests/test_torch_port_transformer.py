"""The transformer sequence classifier of the port
(``sgc_tpu_torch/models/transformer.py``) against the reference's
(``sgc_tpu/models/transformer.py``), on the CPU.

Both packages get the reference's parameters
(``init_transformer(PRNGKey(k))``, carried over by ``params_from_jax``)
and the same ids and masks, made with numpy from a seed; the dropout
masks are the reference's own ``jax.random.bernoulli`` draws, rebuilt
from its key splits (transformer.py:164-173, 196-200).

Tolerances:
* logits to f32 rounding, 1e-5 of max|ref|: both round the same operands
  to bf16 and sum their products in f32, in another order;
* gradients, 2^-7 of max|ref| per parameter (the bf16 recipe's bound):
  the backward rounds the weight gradients to bf16 and back on both
  sides (the transpose of the cast), so an f32 difference that crosses a
  bf16 rounding boundary moves one element by one bf16 step, at most
  2^-7 of its magnitude (measured: at most 1.6e-4 of max, with
  dropout).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sgc_tpu.models import transformer as ref

from sgc_tpu_torch.models import transformer as port
from sgc_tpu_torch.ops import autograd

LOGIT_TOL = 1e-5
GRAD_TOL = 2.0 ** -7
CPU = "cpu"


def tiny(**kw):
    return ref.TransformerConfig(vocab_size=64, n_classes=3, max_len=12,
                                 dim=32, n_heads=2, n_layers=2, **kw)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def batch(seed=0, b=5, l=12, vocab=64):
    """Ids and masks with a full row, a front-padded row and an empty doc
    (every position masked)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[1, :5] = 0.0
    ids[1, :5] = 0
    mask[2] = 0.0
    ids[2] = 0
    return ids, mask


def ref_masks(key, n_layers, shape, rate):
    """The reference's dropout masks, two per layer, from its key chain."""
    out = []
    for _ in range(n_layers):
        for _ in range(2):
            key, sub = jax.random.split(key)
            out.append(torch.from_numpy(np.array(
                jax.random.bernoulli(sub, 1.0 - rate, shape))))
    return out


def layer_grads(model):
    yield "tok_emb", model.tok_emb.grad
    yield "pos_emb", model.pos_emb.grad
    for i, p in enumerate(model.layers):
        for k in port.LAYER_KEYS:
            yield f"{i}.{k}", getattr(p, k).grad
    for k in ("ln_f_g", "ln_f_b", "cls_w", "cls_b"):
        yield k, getattr(model, k).grad


def ref_grads(g):
    yield "tok_emb", g.tok_emb
    yield "pos_emb", g.pos_emb
    for i, p in enumerate(g.layers):
        for k in port.LAYER_KEYS:
            yield f"{i}.{k}", getattr(p, k)
    for k in ("ln_f_g", "ln_f_b", "cls_w", "cls_b"):
        yield k, getattr(g, k)


def test_params_carry_over_and_are_exported():
    params = ref.init_transformer(jax.random.PRNGKey(0), tiny())
    model = port.params_from_jax(params, CPU)
    assert model.n_heads == 2 and len(model.layers) == 2
    got = {n.replace("layers.", ""): t for n, t in model.named_parameters()}
    want = dict(ref_grads(params))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].detach().numpy(),
                                      np.asarray(w), err_msg=name)
    from sgc_tpu_torch import models

    assert models.init_transformer is port.init_transformer
    assert models.transformer_apply is port.transformer_apply


@pytest.mark.parametrize("head_only", [False, True])
def test_logits_match_reference(head_only):
    params = ref.init_transformer(jax.random.PRNGKey(3), tiny())
    ids, mask = batch(3)
    want = np.asarray(ref.transformer_apply(
        params, jnp.asarray(ids), jnp.asarray(mask), head_only=head_only))
    got = port.transformer_apply(
        port.params_from_jax(params, CPU), torch.from_numpy(ids),
        torch.from_numpy(mask), head_only=head_only).detach().numpy()
    assert rel_err(got, want) <= LOGIT_TOL
    # the empty doc pools to 0 and gets the head's bias: finite
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)


def test_dropout_with_reference_masks_matches():
    cfg = tiny()
    params = ref.init_transformer(jax.random.PRNGKey(4), cfg)
    ids, mask = batch(4)
    key = jax.random.PRNGKey(9)
    want = np.asarray(ref.transformer_apply(
        params, jnp.asarray(ids), jnp.asarray(mask), dropout_rate=0.25,
        dropout_key=key))
    masks = ref_masks(key, cfg.n_layers, (5, 12, cfg.dim), 0.25)
    got = port.transformer_apply(
        port.params_from_jax(params, CPU), torch.from_numpy(ids),
        torch.from_numpy(mask), dropout_rate=0.25,
        dropout_masks=masks).detach().numpy()
    assert rel_err(got, want) <= LOGIT_TOL
    # without masks or a generator, dropout is off (the reference's
    # key=None)
    plain = port.transformer_apply(
        port.params_from_jax(params, CPU), torch.from_numpy(ids),
        torch.from_numpy(mask), dropout_rate=0.25).detach().numpy()
    want0 = np.asarray(ref.transformer_apply(
        params, jnp.asarray(ids), jnp.asarray(mask), dropout_rate=0.25))
    assert rel_err(plain, want0) <= LOGIT_TOL


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_gradients_match_reference(dropout):
    cfg = tiny()
    params = ref.init_transformer(jax.random.PRNGKey(5), cfg)
    ids, mask = batch(5)
    y = np.array([0, 1, 2, 1, 0])
    w = np.array([1, 1, 1, 1, 0], np.float32)
    key = jax.random.PRNGKey(11) if dropout else None

    def loss_fn(p):
        logits = ref.transformer_apply(p, jnp.asarray(ids), jnp.asarray(mask),
                                       dropout_rate=dropout, dropout_key=key)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y))
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

    loss, g = jax.value_and_grad(loss_fn)(params)
    model = port.params_from_jax(params, CPU)
    masks = (ref_masks(key, cfg.n_layers, (5, 12, cfg.dim), dropout)
             if dropout else None)
    from sgc_tpu_torch.train.sequence import weighted_cross_entropy

    logits = port.transformer_apply(
        model, torch.from_numpy(ids), torch.from_numpy(mask),
        dropout_rate=dropout, dropout_masks=masks)
    got_loss = weighted_cross_entropy(logits, torch.from_numpy(y),
                                      torch.from_numpy(w))
    got_loss.backward()
    assert abs(float(got_loss.detach()) - float(loss)) <= (
        LOGIT_TOL * abs(float(loss)))
    for (name, got), (_, want) in zip(layer_grads(model), ref_grads(g)):
        assert rel_err(got.numpy(), want) <= GRAD_TOL, name


def test_padding_invariance():
    """Front padding must not change the logits of the real tokens
    (the reference's own case, tests/test_sampling_transformer.py)."""
    params = ref.init_transformer(jax.random.PRNGKey(1), tiny())
    model = port.params_from_jax(params, CPU)
    toks = np.random.default_rng(1).integers(2, 64, 6)
    ids_a = np.zeros((1, 12), np.int32)
    mask_a = np.zeros((1, 12), np.float32)
    ids_a[0, 6:] = toks
    mask_a[0, 6:] = 1.0
    ids_b = ids_a.copy()
    ids_b[0, :6] = 37  # garbage in padded region
    la = port.transformer_apply(model, torch.from_numpy(ids_a),
                                torch.from_numpy(mask_a))
    lb = port.transformer_apply(model, torch.from_numpy(ids_b),
                                torch.from_numpy(mask_a))
    np.testing.assert_allclose(la.detach().numpy(), lb.detach().numpy(),
                               atol=2e-2)


def test_head_only_freezes_encoder():
    params = ref.init_transformer(jax.random.PRNGKey(2), tiny())
    ids = torch.from_numpy(
        np.random.default_rng(2).integers(0, 64, (2, 12)).astype(np.int32))
    mask = torch.ones((2, 12))
    for head_only in (True, False):
        model = port.params_from_jax(params, CPU)
        (port.transformer_apply(model, ids, mask, head_only=head_only) ** 2
         ).sum().backward()
        wq = model.layers[0].wq.grad
        if head_only:
            assert wq is None and model.tok_emb.grad is None
        else:
            assert float(wq.abs().max()) > 0.0
        assert float(model.cls_w.grad.abs().max()) > 0.0


def test_init_draws_the_reference_distributions():
    cfg = tiny(dropout=0.1)
    model = port.init_transformer(cfg, torch.Generator().manual_seed(0), CPU)
    assert model.tok_emb.shape == (64, 32) and model.pos_emb.shape == (12, 32)
    assert model.cls_w.shape == (32, 3)
    assert abs(float(model.tok_emb.std()) - 0.02) < 0.003
    w1 = model.layers[0].w1
    assert w1.shape == (32, 128)
    assert abs(float(w1.std()) - (2.0 / 32) ** 0.5) < 0.03
    assert float(model.layers[1].ln2_g.sum()) == 32.0
    again = port.init_transformer(cfg, torch.Generator().manual_seed(0), CPU)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_generator_dropout_repeats_and_differs_from_none():
    params = ref.init_transformer(jax.random.PRNGKey(6), tiny())
    model = port.params_from_jax(params, CPU)
    ids, mask = (torch.from_numpy(a) for a in batch(6))
    a = port.transformer_apply(model, ids, mask, dropout_rate=0.5,
                               generator=torch.Generator().manual_seed(1))
    b = port.transformer_apply(model, ids, mask, dropout_rate=0.5,
                               generator=torch.Generator().manual_seed(1))
    c = port.transformer_apply(model, ids, mask)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_gather_rows_backward_is_the_sequential_scatter_add():
    """The embedding gradient through kernel B's plain version: each row
    sums its positions in increasing order from zero, as the
    reference's scatter-add does, so the bits match."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((20, 8)).astype(np.float32)
    ids = rng.integers(0, 20, (4, 9)).astype(np.int32)
    g = rng.standard_normal((4, 9, 8)).astype(np.float32)

    want = np.asarray(jax.vjp(lambda t: t[jnp.asarray(ids)],
                              jnp.asarray(table))[1](jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_()
    out = autograd.GatherRowsFn.apply(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), want)
