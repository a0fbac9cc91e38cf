"""Reddit dataset loader (the counterpart of sgc_tpu/data/reddit.py).

The FastGCN export (``reddit_adj.npz`` + ``reddit.npz``): labels
scattered from the per-split vectors, ``adj = adj + adj.T``, the
train-only sub-adjacency ``adj[train][:, train]`` for inductive
training, both normalized on the host (bit for bit the reference's) and
placed on the device, and the features standardized there (zero mean,
unbiased unit std per column).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from sgc_tpu_torch.graph.normalize import (
    fetch_normalization,
    standardize_features,
)
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.paths import data_dir


@dataclasses.dataclass(frozen=True)
class RedditData:
    graph: SparseGraph        # normalized full adjacency, on the device
    train_graph: SparseGraph  # normalized train-only sub-adjacency
    features: torch.Tensor    # standardized float32[N, F]
    labels: torch.Tensor      # int64[N]
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    n_classes: int


def load_reddit(normalization: str = "AugNormAdj",
                data_path: str | None = None, device=None) -> RedditData:
    """Load the pair from ``data_path`` (``utils.paths.data_dir``) onto
    ``device`` (``None`` -> the card; raises without one)."""
    dev = resolve_device(device)
    root = data_dir(data_path)
    adj = sp.load_npz(root / "reddit_adj.npz")
    with np.load(root / "reddit.npz") as data:
        arrays = {k: data[k] for k in data.files}
    train_index = arrays["train_index"]
    val_index = arrays["val_index"]
    test_index = arrays["test_index"]

    labels = np.zeros(adj.shape[0], dtype=np.int64)
    labels[train_index] = arrays["y_train"]
    labels[val_index] = arrays["y_val"]
    labels[test_index] = arrays["y_test"]

    adj = adj + adj.T
    train_adj = adj[train_index, :][:, train_index]

    normalizer = fetch_normalization(normalization)
    graph = SparseGraph.from_scipy(normalizer(adj)).to(dev)
    train_graph = SparseGraph.from_scipy(normalizer(train_adj)).to(dev)
    features = standardize_features(
        torch.as_tensor(arrays["feats"], dtype=torch.float32, device=dev))

    return RedditData(
        graph=graph, train_graph=train_graph, features=features,
        labels=torch.as_tensor(labels, device=dev),
        idx_train=np.asarray(train_index), idx_val=np.asarray(val_index),
        idx_test=np.asarray(test_index),
        n_classes=int(labels.max()) + 1,
    )
