"""Transformer sequence-classifier CLI (the counterpart of
sgc_tpu/cli/sequence.py, the reference's xlnet/xlnet.py baseline), on the
card by default:

    python -m sgc_tpu_torch.cli.sequence --metadata data/ohsumed.txt \
        --corpus data/ohsumed.clean.txt --epochs 4

Trains the encoder classifier on a text dataset's metadata and cleaned
corpus (the inputs of the build_graph CLI) and prints the test accuracy
and weighted F1: the TextSGC-vs-transformer baseline comparison.
"""

from __future__ import annotations

import argparse

import numpy as np

from sgc_tpu_torch.models.transformer import TransformerConfig
from sgc_tpu_torch.textgraph.graph import TextCorpus
from sgc_tpu_torch.train.metrics import f1_weighted
from sgc_tpu_torch.train.sequence import (
    SeqTrainConfig,
    predict_sequence,
    train_sequence_classifier,
)
from sgc_tpu_torch.utils.device import resolve_device


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--metadata", required=True)
    p.add_argument("--corpus", required=True)
    p.add_argument("--max_len", type=int, default=256)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--vocab_size", type=int, default=30000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--head_only", action="store_true",
                   help="freeze encoder, train classifier head only")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def run(a: argparse.Namespace) -> dict:
    """Train and evaluate; returns the model, vocab, predictions and the
    test accuracy and weighted F1."""
    dev = resolve_device(a.device)
    tc = TextCorpus.from_files(a.metadata, a.corpus)
    label_to_idx = {l: i for i, l in enumerate(tc.label_names)}
    y = np.asarray([label_to_idx[l] for l in tc.labels], np.int32)
    is_train = np.asarray([ph == "train" for ph in tc.phases])

    train_docs = [d for d, t in zip(tc.doc_tokens, is_train) if t]
    test_docs = [d for d, t in zip(tc.doc_tokens, is_train) if not t]
    y_train, y_test = y[is_train], y[~is_train]

    model_cfg = TransformerConfig(
        vocab_size=a.vocab_size, n_classes=len(tc.label_names),
        max_len=a.max_len, dim=a.dim, n_heads=a.heads, n_layers=a.layers,
        dropout=a.dropout,
    )
    model, vocab = train_sequence_classifier(
        train_docs, y_train, model_cfg,
        SeqTrainConfig(
            lr=a.lr, epochs=a.epochs, batch_size=a.batch_size,
            dropout=a.dropout, head_only=a.head_only, seed=a.seed,
        ),
        device=dev,
    )
    preds = predict_sequence(model, test_docs, vocab, a.max_len)
    return {"model": model, "vocab": vocab, "predictions": preds,
            "n_classes": len(tc.label_names),
            "test_accuracy": float((preds == y_test).mean()),
            "f1_weighted": f1_weighted(preds, y_test)}


def main() -> None:
    r = run(parser().parse_args())
    print(f"Test accuracy: {r['test_accuracy']:.4f}  "
          f"weighted-F1: {r['f1_weighted']:.4f}")


if __name__ == "__main__":
    main()
