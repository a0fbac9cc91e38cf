"""Stratified k-fold cross-validation ids (the counterpart of
sgc_tpu/data/crossval.py).

Each fold writes ``ind.<ds>.<fold>.{train,val,test}.{x,y}`` pickles: the
fold's held-out chunk is the test set and a seeded slice of the rest is
validation. The folds are scikit-learn's ``StratifiedKFold`` folds, bit
for bit: :func:`stratified_kfold_split` is the port's own copy of that
allocation (the port does not depend on scikit-learn).
"""

from __future__ import annotations

import pickle
import warnings
from pathlib import Path

import numpy as np


def stratified_kfold_split(y: np.ndarray, n_splits: int,
                           shuffle: bool = False,
                           random_state: int | None = None):
    """Yield ``(train_index, test_index)`` per fold, as
    ``StratifiedKFold(n_splits, shuffle=shuffle,
    random_state=random_state).split(ids, y)`` does: classes numbered by
    first appearance, each fold's share of a class dealt round robin over
    the sorted labels, and each class's samples given their folds in
    blocks, in data order (the blocks permuted per class by
    ``RandomState(random_state)`` when ``shuffle``)."""
    y = np.asarray(y)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits}"
                         f" greater than the number of samples: "
                         f"n_samples={len(y)}.")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the "
                         "number of members in each class.")
    if n_splits > np.min(y_counts):
        warnings.warn(f"The least populated class in y has only "
                      f"{np.min(y_counts)} members, which is less than "
                      f"n_splits={n_splits}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    rng = np.random.RandomState(random_state) if shuffle else None
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    for i in range(n_splits):
        test = test_folds == i
        yield indices[~test], indices[test]


def make_crossval_ids(
    metadata_path: str | Path,
    out_dir: str | Path,
    dataset: str,
    n_folds: int = 5,
    val_fraction: float = 0.1,
    seed: int = 42,
    shuffle: bool = False,
) -> list[dict]:
    """Generate per-fold id/label pickles from a metadata file.

    Metadata lines: ``<id>\\t<train|test>\\t<label>``; the original
    train/test phases are ignored, the folds re-split ALL docs.
    Unshuffled (the reference's default) each fold is contiguous
    per-class chunks; ``shuffle=True`` is an opt-in deviation.
    """
    labels = []
    with open(metadata_path) as f:
        for line in f:
            labels.append(line.strip().split("\t")[2])
    label_names = sorted(set(labels))
    label_to_idx = {l: i for i, l in enumerate(label_names)}
    y = np.asarray([label_to_idx[l] for l in labels])

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    splits = stratified_kfold_split(y, n_folds, shuffle,
                                    seed if shuffle else None)
    folds = []
    for fold, (train_val, test) in enumerate(splits):
        train_val = train_val[rng.permutation(len(train_val))]
        n_val = int(val_fraction * len(train_val))
        split = {"train": train_val[n_val:], "val": train_val[:n_val],
                 "test": test}
        for phase, idx in split.items():
            with open(out_dir / f"ind.{dataset}.{fold}.{phase}.x", "wb") as f:
                pickle.dump([int(i) for i in idx], f)
            with open(out_dir / f"ind.{dataset}.{fold}.{phase}.y", "wb") as f:
                pickle.dump([int(y[i]) for i in idx], f)
        folds.append({p: np.asarray(i) for p, i in split.items()})
    return folds
