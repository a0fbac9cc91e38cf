"""Pretrained-encoder fine-tuning (the counterpart of
sgc_tpu/train/finetune.py), the true XLNet-baseline path.

``train.sequence`` trains the self-contained encoder from scratch. When
HuggingFace weights are available this module fine-tunes a real
pretrained encoder instead: a PyTorch
``AutoModelForSequenceClassification`` on the card, where the reference
runs the flax one. ``transformers`` is imported lazily, inside
:func:`finetune_pretrained`, as the reference gates it (finetune.py:
104-127); ``from_config=True`` instantiates the architecture with random
weights (offline).

The step is the reference's (finetune.py:144-162): the weighted mean
cross-entropy, head-only mode zeroing the encoder's gradients (the
reference multiplies them by a 0/1 mask before the optimizer), optax's
global-norm clip (``train.sequence.clip_by_global_norm_``), Adam. The
reference applies the model with ``train=False``, so no dropout is ever
active while it fine-tunes; the port keeps the model in ``eval()`` mode
through its steps for the same forward.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from sgc_tpu_torch.train.sequence import (
    clip_by_global_norm_,
    pad_batch_indices,
    weighted_cross_entropy,
)
from sgc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class FinetuneConfig:
    model_name: str = "bert-base-uncased"
    lr: float = 3e-5               # xlnet.py:188
    grad_clip: float = 1.0         # xlnet.py:218
    epochs: int = 3
    batch_size: int = 16
    max_length: int = 128
    head_only: bool = False
    seed: int = 42
    from_config: bool = False      # random init (offline) instead of weights


# module names that make up the classification head across HF
# architectures: BERT family 'classifier', XLNet 'logits_proj' (+
# 'sequence_summary'), some models 'score'
_HEAD_KEYS = ("classifier", "logits_proj", "sequence_summary", "score")


def _head_mask(names: Iterable[str]) -> dict[str, float]:
    """``{name: 1.0}`` for parameters under a classification-head module,
    ``0.0`` for the encoder's, over dotted torch parameter names: a name
    is in the head when any of its components contains one of
    ``_HEAD_KEYS`` (the reference walks the flax dict's keys the same
    way). Raises if no head parameter is found: an all-zero mask would
    freeze the whole model and make fine-tuning a no-op."""
    mask = {n: float(any(h in part.lower() for part in n.split(".")
                         for h in _HEAD_KEYS)) for n in names}
    if not any(mask.values()):
        top = sorted({n.split(".")[0] for n in mask})
        raise ValueError(
            "head_only=True but no classification-head module recognized "
            f"(looked for {_HEAD_KEYS} among param names; top-level: {top}). "
            "Pass head_only=False or rename/extend _HEAD_KEYS."
        )
    return mask


def finetune_pretrained(
    texts: Sequence[str],
    labels: np.ndarray,
    n_classes: int,
    config: FinetuneConfig | None = None,
    tokenizer=None,
    model=None,
    device=None,
):
    """Fine-tune a sequence classifier on ``device`` (``None`` -> the
    card); returns ``(predict_fn, (model, optimizer))``.

    ``predict_fn(texts) -> int predictions``. ``tokenizer``/``model`` may
    be passed directly (locally constructed HF objects, as offline runs
    and the tests do); otherwise they resolve from ``config.model_name``.
    Raises RuntimeError when pretrained weights cannot be loaded and
    ``from_config`` is False.
    """
    cfg = config or FinetuneConfig()
    dev = resolve_device(device)
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(cfg.model_name)
    if model is None:
        from transformers import AutoConfig, AutoModelForSequenceClassification

        if cfg.from_config:
            mcfg = AutoConfig.from_pretrained(cfg.model_name)
            mcfg.num_labels = n_classes
            model = AutoModelForSequenceClassification.from_config(mcfg)
        else:
            try:
                model = AutoModelForSequenceClassification.from_pretrained(
                    cfg.model_name, num_labels=n_classes)
            except (ImportError, OSError, ValueError) as e:
                raise RuntimeError(
                    f"pretrained weights for {cfg.model_name!r} unavailable "
                    f"({e}); pass from_config=True or inject model="
                ) from e
    # no dropout while training, as the reference's train=False
    model = model.to(dev).eval()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    opt = torch.optim.Adam([p for _, p in named], lr=cfg.lr)
    frozen = []
    if cfg.head_only:
        head = _head_mask(n for n, _ in named)
        frozen = [p for n, p in named if not head[n]]

    def encode(batch_texts):
        enc = tokenizer(
            list(batch_texts), padding="max_length", truncation=True,
            max_length=cfg.max_length, return_tensors="np",
        )
        return (torch.from_numpy(enc["input_ids"]).long().to(dev),
                torch.from_numpy(enc["attention_mask"]).long().to(dev))

    labels_d = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    n = len(texts)
    b = min(cfg.batch_size, max(n, 1))
    rng = np.random.default_rng(cfg.seed)
    for _ in range(cfg.epochs):
        perm = rng.permutation(n)
        for s in range(0, n, b):
            idx, w = pad_batch_indices(perm[s : s + b], b)
            ids, attn = encode([texts[i] for i in idx])
            opt.zero_grad(set_to_none=True)
            logits = model(input_ids=ids, attention_mask=attn).logits
            loss = weighted_cross_entropy(
                logits, labels_d[torch.from_numpy(idx).to(dev)],
                torch.from_numpy(w).to(dev))
            loss.backward()
            for p in frozen:
                if p.grad is not None:
                    p.grad.zero_()
            clip_by_global_norm_([p for _, p in named], cfg.grad_clip)
            opt.step()

    @torch.no_grad()
    def predict_fn(batch_texts):
        out = np.zeros(len(batch_texts), np.int32)
        for s in range(0, len(batch_texts), b):
            chunk = list(batch_texts[s : s + b])
            ids, attn = encode(chunk + [""] * (b - len(chunk)))
            pred = model(input_ids=ids, attention_mask=attn).logits.argmax(-1)
            out[s : s + len(chunk)] = pred.cpu().numpy()[: len(chunk)]
        return out

    return predict_fn, (model, opt)
