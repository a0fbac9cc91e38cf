"""Transformer sequence classifier (the counterpart of
sgc_tpu/models/transformer.py), the from-scratch baseline that TextSGC is
compared with (the reference's XLNet run, sgc_tpu/cli/sequence.py:1-11).

An encoder-only transformer: pre-LN layers, GELU MLP, learned positions,
mean pooling over the real tokens, a linear head. The parameters keep
the reference's names and layouts (``wq`` ... ``ln2_b`` per layer,
``tok_emb``, ``pos_emb``, ``ln_f_g``/``ln_f_b``, ``cls_w``/``cls_b``;
weights ``(in, out)``, applied as ``x @ w``), so they carry across
unchanged (:func:`params_from_jax`).

The precision recipe is the reference's (transformer.py:132-135,
:154-156): both operands of every product are rounded to bf16 and the
product is summed and returned in f32. The port multiplies the
bf16-rounded operands widened to f32, so the result is f32 as in the
reference (a bf16 ``torch.matmul`` would round it to bf16), and
autograd's backward of the casts rounds the weight gradients to bf16 and
back as JAX's transpose of the cast does. The products are plain FP32
``torch.matmul``s: the reference leaves them to XLA, outside any Pallas
kernel. TF32 stays off (torch's default), since it would truncate the
f32 cotangents.

Masked attention scores are set to ``finfo(float32).min``, not ``-inf``
(:151-152): a row with no real token then gets a uniform softmax and
finite logits. GELU is the tanh form (``jax.nn.gelu``'s default) and the
layer norm uses the population variance with eps 1e-5. Dropout keeps
with probability ``1 - rate`` and scales by ``1 / keep``; its masks come
from a ``torch.Generator`` or are passed in (the tests pass the
reference's). The embedding lookup is ``ops.autograd.GatherRowsFn``,
whose backward is kernel B, so a step gives the same bits on every run.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgc_tpu_torch.ops.autograd import GatherRowsFn
from sgc_tpu_torch.utils.device import resolve_device

LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2",
              "ln1_g", "ln1_b", "ln2_g", "ln2_b")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    n_classes: int
    max_len: int = 256
    dim: int = 256
    n_heads: int = 4
    n_layers: int = 4
    mlp_ratio: int = 4
    dropout: float = 0.1


class EncoderLayer(nn.Module):
    """One pre-LN encoder layer's parameters, named as the reference's
    ``EncoderLayerParams``."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for k in LAYER_KEYS:
            setattr(self, k, nn.Parameter(tensors[k]))


class Transformer(nn.Module):
    """The classifier's parameters, named as the reference's
    ``TransformerParams``; :func:`transformer_apply` is the forward
    pass."""

    def __init__(self, tok_emb: torch.Tensor, pos_emb: torch.Tensor,
                 layers: list[EncoderLayer], ln_f_g: torch.Tensor,
                 ln_f_b: torch.Tensor, cls_w: torch.Tensor,
                 cls_b: torch.Tensor, n_heads: int):
        super().__init__()
        self.tok_emb = nn.Parameter(tok_emb)
        self.pos_emb = nn.Parameter(pos_emb)
        self.layers = nn.ModuleList(layers)
        self.ln_f_g = nn.Parameter(ln_f_g)
        self.ln_f_b = nn.Parameter(ln_f_b)
        self.cls_w = nn.Parameter(cls_w)
        self.cls_b = nn.Parameter(cls_b)
        self.n_heads = int(n_heads)


def init_transformer(cfg: TransformerConfig, generator: torch.Generator,
                     device=None) -> Transformer:
    """A new classifier drawn from ``generator`` (on its own device), then
    placed on ``device`` (``None`` -> the card), following
    transformer.py:88-123: embeddings N(0, 0.02^2), weights N(0, 2 /
    fan_in), biases 0, norm gains 1. Draw order: ``tok_emb``,
    ``pos_emb``, ``cls_w``, then each layer's ``wq``, ``wk``, ``wv``,
    ``wo``, ``w1``, ``w2``."""
    dev = resolve_device(device)
    d, h = cfg.dim, cfg.mlp_ratio * cfg.dim

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=generator.device)
        return t.normal_(0.0, 1.0, generator=generator) * std

    def dense(fan_in, shape):
        return normal(shape, math.sqrt(2.0 / fan_in))

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32)

    def ones(n):
        return torch.ones(n, dtype=torch.float32)

    tok_emb = normal((cfg.vocab_size, d), 0.02)
    pos_emb = normal((cfg.max_len, d), 0.02)
    cls_w = dense(d, (d, cfg.n_classes))
    layers = []
    for _ in range(cfg.n_layers):
        t = dict(wq=dense(d, (d, d)), wk=dense(d, (d, d)),
                 wv=dense(d, (d, d)), wo=dense(d, (d, d)),
                 w1=dense(d, (d, h)), w2=dense(h, (h, d)))
        t.update(b1=zeros(h), b2=zeros(d), ln1_g=ones(d), ln1_b=zeros(d),
                 ln2_g=ones(d), ln2_b=zeros(d))
        layers.append(EncoderLayer(**{k: v.to(dev) for k, v in t.items()}))
    return Transformer(tok_emb.to(dev), pos_emb.to(dev), layers,
                       ones(d).to(dev), zeros(d).to(dev), cls_w.to(dev),
                       zeros(cfg.n_classes).to(dev), cfg.n_heads)


def params_from_jax(params, device=None) -> Transformer:
    """A classifier holding the values of the reference's
    ``TransformerParams`` (any object with those array attributes, its
    ``layers`` a sequence of objects with the layer's arrays)."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    layers = [EncoderLayer(**{k: t(getattr(p, k)) for k in LAYER_KEYS})
              for p in params.layers]
    return Transformer(t(params.tok_emb), t(params.pos_emb), layers,
                       t(params.ln_f_g), t(params.ln_f_b), t(params.cls_w),
                       t(params.cls_b), int(params.n_heads))


def _layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _mm(a, w):
    """bf16 operands, f32 product and result (transformer.py:132-135)."""
    return _bf16(a) @ _bf16(w)


def _attention(x, p: EncoderLayer, mask, n_heads: int):
    """Multi-head self-attention; ``mask`` float (B, L), 1 = real."""
    b, l, d = x.shape
    hd = d // n_heads

    def split(t):  # (B, L, D) -> (B, H, L, hd)
        return t.reshape(b, l, n_heads, hd).transpose(1, 2)

    q = split(_mm(x, p.wq))
    k = split(_mm(x, p.wk))
    v = split(_mm(x, p.wv))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    neg = torch.finfo(torch.float32).min
    scores = scores.masked_fill(mask[:, None, None, :] <= 0, neg)
    probs = torch.softmax(scores, dim=-1)
    ctx = _bf16(probs) @ _bf16(v)
    ctx = ctx.transpose(1, 2).reshape(b, l, d)
    return _mm(ctx, p.wo)


def transformer_apply(model: Transformer, token_ids: torch.Tensor,
                      mask: torch.Tensor, *, dropout_rate: float = 0.0,
                      generator: torch.Generator | None = None,
                      dropout_masks=None,
                      head_only: bool = False) -> torch.Tensor:
    """Logits ``(B, n_classes)`` of int ids ``(B, L)`` under the float
    ``mask`` ``(B, L)`` (1 = real token).

    Dropout runs when ``dropout_rate > 0`` and either ``generator`` (on
    the ids' device) draws the keep masks or ``dropout_masks`` gives them:
    bool ``(B, L, D)`` tensors, two per layer in order (after the
    attention, after the MLP), as the reference draws them
    (transformer.py:164-173). ``head_only`` detaches the pooled vector,
    so only the head gets gradients (transformer.py:206-207); dropout
    still applies.
    """
    active = dropout_rate > 0.0 and (generator is not None
                                     or dropout_masks is not None)
    masks = iter(dropout_masks) if dropout_masks is not None else None
    keep = 1.0 - dropout_rate

    def drop(h):
        if not active:
            return h
        m = (next(masks) if masks is not None else
             torch.rand(h.shape, generator=generator, device=h.device) < keep)
        return torch.where(m, h / keep, 0.0)

    l = token_ids.shape[1]
    x = GatherRowsFn.apply(model.tok_emb, token_ids) + model.pos_emb[:l][None]
    for p in model.layers:
        h = _layer_norm(x, p.ln1_g, p.ln1_b)
        x = x + drop(_attention(h, p, mask, model.n_heads))
        h = _layer_norm(x, p.ln2_g, p.ln2_b)
        h = F.gelu(_mm(h, p.w1) + p.b1, approximate="tanh")
        x = x + drop(_mm(h, p.w2) + p.b2)
    x = _layer_norm(x, model.ln_f_g, model.ln_f_b)
    # mean over the real tokens; a doc with none divides by 1
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    pooled = (x * mask[..., None]).sum(dim=1) / denom
    if head_only:
        pooled = pooled.detach()
    return _mm(pooled, model.cls_w) + model.cls_b
