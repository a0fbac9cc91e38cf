"""Evaluation metrics (the counterpart of sgc_tpu/train/metrics.py).

``accuracy`` runs in torch on the logits' device; the F1 family and the
"Optimized Precision" score count on the host in numpy, as in the
reference, and take tensors or arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import host


def hit_rate(preds: torch.Tensor, labels: torch.Tensor) -> float:
    """Fraction of ``preds`` equal to ``labels``, in f32 as the reference
    computes its mean: the count times f32(1/n) (XLA folds the division
    into that product), so both give the same bits."""
    hits = (preds == labels.to(preds.device)).sum().float()
    inv_n = torch.tensor(1.0 / max(int(preds.shape[0]), 1),
                         dtype=torch.float32, device=hits.device)
    return float(hits * inv_n)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Fraction of rows whose argmax matches the label."""
    return hit_rate(logits.argmax(dim=1), labels)


def _per_class_counts(preds: np.ndarray, labels: np.ndarray, n_classes: int):
    tp = np.zeros(n_classes)
    fp = np.zeros(n_classes)
    fn = np.zeros(n_classes)
    for c in range(n_classes):
        tp[c] = np.sum((preds == c) & (labels == c))
        fp[c] = np.sum((preds == c) & (labels != c))
        fn[c] = np.sum((preds != c) & (labels == c))
    return tp, fp, fn


def _f1_from_counts(tp, fp, fn):
    denom = 2 * tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(denom > 0, 2 * tp / denom, 0.0)


def f1(logits, labels) -> tuple[float, float]:
    """(micro, macro) F1 over argmax predictions; macro averages over the
    classes present in labels or predictions (sklearn's label set)."""
    preds = host(logits).argmax(axis=1)
    labels = host(labels)
    classes = np.union1d(np.unique(preds), np.unique(labels))
    n = int(classes.max()) + 1 if classes.size else 1
    tp, fp, fn = _per_class_counts(preds, labels, n)
    per_class = _f1_from_counts(tp, fp, fn)[classes.astype(int)]
    micro_tp, micro_fp, micro_fn = tp.sum(), fp.sum(), fn.sum()
    denom = 2 * micro_tp + micro_fp + micro_fn
    micro = 2 * micro_tp / denom if denom > 0 else 0.0
    return float(micro), float(per_class.mean())


def f1_macro(preds, labels) -> float:
    """Unweighted class-mean F1 over classes present in labels or preds
    (sklearn ``average='macro'`` on the union label set)."""
    preds, labels = host(preds), host(labels)
    classes = np.union1d(np.unique(preds), np.unique(labels))
    n = int(classes.max()) + 1 if classes.size else 1
    tp, fp, fn = _per_class_counts(preds, labels, n)
    return float(_f1_from_counts(tp, fp, fn)[classes.astype(int)].mean())


def f1_weighted(preds, labels) -> float:
    """Support-weighted F1 (sklearn ``average='weighted'``)."""
    preds, labels = host(preds), host(labels)
    classes = np.unique(labels)
    n = int(max(preds.max(initial=0), labels.max(initial=0))) + 1
    tp, fp, fn = _per_class_counts(preds, labels, n)
    per_class = _f1_from_counts(tp, fp, fn)
    support = np.array([(labels == c).sum() for c in classes],
                       dtype=np.float64)
    return float((per_class[classes] * support).sum() / support.sum())


def optimized_precision(preds, labels) -> float:
    """OP = mean_acc - |mean_spec - mean_recall| / (mean_spec + mean_recall):
    per-class one-vs-rest counts over the sorted union of classes in
    labels or predictions, then the class means of specificity, recall
    and one-vs-rest accuracy (not the overall multiclass accuracy)."""
    preds, labels = host(preds), host(labels)
    classes = np.union1d(np.unique(labels), np.unique(preds))
    total = len(labels)
    sens, spec, accs = [], [], []
    for c in classes:
        tp = np.sum((preds == c) & (labels == c))
        fn = np.sum((preds != c) & (labels == c))
        fp = np.sum((preds == c) & (labels != c))
        tn = total - tp - fn - fp
        sens.append(tp / (tp + fn) if (tp + fn) else 0.0)
        spec.append(tn / (tn + fp) if (tn + fp) else 0.0)
        accs.append((tp + tn) / total if total else 0.0)
    se, sp = float(np.mean(sens)), float(np.mean(spec))
    mean_acc = float(np.mean(accs))
    if se + sp == 0:
        return mean_acc
    return mean_acc - abs(sp - se) / (sp + se)
