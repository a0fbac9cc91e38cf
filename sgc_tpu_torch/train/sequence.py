"""Sequence-classifier training (the counterpart of
sgc_tpu/train/sequence.py), the XLNet fine-tune analog.

Word-level encoding with front padding (``build_seq_vocab``,
``encode_batch``, ``pad_batch_indices``: copies of the reference's, so
the encodings and the batch order match bit for bit), then Adam steps
over fixed-shape ``(B, L)`` batches on the card; the last batch is padded
with rows of weight 0 (the reference's static-shape padding).

A step is the reference's jitted step (sequence.py:117-138) written out:
the weighted mean cross-entropy ``sum(ce * w) / max(sum(w), 1)``, its
gradients, optax's ``clip_by_global_norm`` (scale by ``max_norm / norm``
only when ``norm >= max_norm``; torch's ``clip_grad_norm_`` scales by
``max_norm / (norm + 1e-6)`` always, so the port keeps its own clip, on
the device, with no host sync), then ``torch.optim.Adam`` at optax's
defaults (betas 0.9, 0.999, eps 1e-8). The dropout masks come from a
``torch.Generator`` on the card, seeded with ``cfg.seed``; the batch
order is the reference's numpy permutation.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sgc_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    init_transformer,
    transformer_apply,
)
from sgc_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Word-level encoding (front- or back-padded, xlnet.py:76-128)
# ---------------------------------------------------------------------------


def build_seq_vocab(
    docs: Sequence[Sequence[str]], max_vocab: int = 50_000
) -> dict[str, int]:
    """Frequency-ranked word vocab; 0 = PAD, 1 = UNK."""
    counts = Counter(w for d in docs for w in d)
    vocab = {"<pad>": 0, "<unk>": 1}
    for w, _ in counts.most_common(max_vocab - 2):
        vocab[w] = len(vocab)
    return vocab


def encode_batch(
    docs: Sequence[Sequence[str]],
    vocab: dict[str, int],
    max_len: int,
    front_pad: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """(ids, mask) with XLNet-style front padding by default (xlnet.py:96)."""
    ids = np.zeros((len(docs), max_len), np.int32)
    mask = np.zeros((len(docs), max_len), np.float32)
    for i, doc in enumerate(docs):
        toks = [vocab.get(w, 1) for w in doc][:max_len]
        if front_pad:
            ids[i, max_len - len(toks):] = toks
            mask[i, max_len - len(toks):] = 1.0
        else:
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1.0
    return ids, mask


def pad_batch_indices(idx: np.ndarray, batch: int):
    """Static-shape batch padding: returns (full_idx, weights) where the
    trailing ``batch - len(idx)`` rows are index 0 with weight 0 (masked
    out of the loss)."""
    w = np.ones(batch, np.float32)
    if len(idx) < batch:
        w[len(idx):] = 0.0
        idx = np.concatenate([idx, np.zeros(batch - len(idx), np.int64)])
    return idx, w


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SeqTrainConfig:
    lr: float = 3e-5               # xlnet.py:188
    grad_clip: float = 1.0         # xlnet.py:218
    epochs: int = 4
    batch_size: int = 32
    dropout: float = 0.1
    head_only: bool = False        # head-only fine-tuning group
    seed: int = 42


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params`` in
    place: unchanged when the global norm is below ``max_norm``, else each
    gradient ``(g / norm) * max_norm``. Parameters with no gradient count
    as zeros. Returns the norm (a device scalar; nothing is fetched)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def weighted_cross_entropy(logits, labels, weights) -> torch.Tensor:
    """``sum(ce * w) / max(sum(w), 1)`` (sequence.py:130-132)."""
    ce = F.cross_entropy(logits, labels.long(), reduction="none")
    return (ce * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def train_step(model: Transformer, opt: torch.optim.Optimizer, ids, mask,
               labels, weights, cfg: SeqTrainConfig,
               generator: torch.Generator | None = None,
               dropout_masks=None) -> torch.Tensor:
    """One step: loss, gradients, the global-norm clip, Adam. Dropout at
    ``cfg.dropout`` draws from ``generator`` or takes ``dropout_masks``
    (see ``transformer_apply``). Returns the loss, on the device."""
    opt.zero_grad(set_to_none=True)
    logits = transformer_apply(
        model, ids, mask, dropout_rate=cfg.dropout, generator=generator,
        dropout_masks=dropout_masks, head_only=cfg.head_only)
    loss = weighted_cross_entropy(logits, labels, weights)
    loss.backward()
    clip_by_global_norm_(model.parameters(), cfg.grad_clip)
    opt.step()
    return loss.detach()


def epoch_batches(rng: np.random.Generator, n: int, b: int):
    """One epoch's ``(idx [steps, b], w [steps, b])``: a permutation from
    ``rng``, cut into batches of ``b``, the last padded."""
    perm = rng.permutation(n)
    cut = [pad_batch_indices(perm[s:s + b], b) for s in range(0, n, b)]
    return (np.stack([c[0] for c in cut]).astype(np.int64),
            np.stack([c[1] for c in cut]))


def train_sequence_classifier(
    docs: Sequence[Sequence[str]],
    labels: np.ndarray,
    model_cfg: TransformerConfig,
    cfg: SeqTrainConfig | None = None,
    *,
    params: Transformer | None = None,
    eval_fn: Callable[[Transformer], None] | None = None,
    device=None,
) -> tuple[Transformer, dict[str, int]]:
    """Fit the classifier on ``device`` (``None`` -> the card); returns
    (model, vocab). ``params`` starts from a given model (moved to the
    device and trained in place); else a new one is drawn from a
    generator seeded with ``cfg.seed``, which then draws the dropout
    masks."""
    cfg = cfg or SeqTrainConfig()
    dev = resolve_device(device)
    vocab = build_seq_vocab(docs, model_cfg.vocab_size)
    ids, mask = encode_batch(docs, vocab, model_cfg.max_len)
    ids_d = torch.from_numpy(ids).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    labels_d = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)

    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    model = (init_transformer(model_cfg, generator, dev) if params is None
             else params.to(dev))
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)

    n = len(docs)
    b = min(cfg.batch_size, n)
    rng = np.random.default_rng(cfg.seed)
    for _ in range(cfg.epochs):
        idx, w = (torch.from_numpy(a).to(dev) for a in epoch_batches(rng, n,
                                                                     b))
        for i, w_b in zip(idx, w):
            train_step(model, opt, ids_d[i], mask_d[i], labels_d[i], w_b,
                       cfg, generator=generator)
        if eval_fn is not None:
            eval_fn(model)
    return model, vocab


@torch.no_grad()
def predict_sequence(
    model: Transformer,
    docs: Sequence[Sequence[str]],
    vocab: dict[str, int],
    max_len: int,
    batch_size: int = 64,
) -> np.ndarray:
    """Argmax class predictions on the model's device, in fixed-shape
    batches padded as the reference pads them; each batch's argmax is
    fetched once."""
    dev = model.cls_w.device
    ids, mask = encode_batch(docs, vocab, max_len)
    n = len(docs)
    out = np.zeros(n, np.int32)
    b = min(batch_size, max(n, 1))
    for s in range(0, n, b):
        idx = np.arange(s, min(s + b, n))
        full, _ = pad_batch_indices(idx, b)
        logits = transformer_apply(model, torch.from_numpy(ids[full]).to(dev),
                                   torch.from_numpy(mask[full]).to(dev))
        out[idx] = logits.argmax(dim=-1).cpu().numpy()[: len(idx)]
    return out
