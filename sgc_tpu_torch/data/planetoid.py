"""Planetoid citation dataset loader, Cora / Citeseer / Pubmed (the
counterpart of sgc_tpu/data/planetoid.py).

The ``ind.<ds>.*`` pickle format, Citeseer's zero-fill of isolated test
nodes, the test-index reorder, max-symmetrization and the canonical
splits (train = the first ``len(y)`` nodes, val = the next 500, test =
the sorted ``test.index``), bit for bit the reference's on the host. The
normalized graph and the row-normalized features are placed on the
device; the index arrays stay numpy.

The pickles are unpickled as the format requires: load only dataset
files from a trusted source.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from sgc_tpu_torch.graph.normalize import (
    fetch_normalization,
    row_normalize,
    symmetrize_max,
)
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.paths import data_dir

PLANETOID_PARTS = ("x", "y", "tx", "ty", "allx", "ally", "graph")


@dataclasses.dataclass(frozen=True)
class CitationData:
    graph: SparseGraph          # normalized adjacency S, on the device
    features: torch.Tensor      # float32[N, F], row-normalized
    labels: torch.Tensor        # int64[N]
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    n_classes: int


def _load_pickle(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def parse_index_file(path: Path) -> list[int]:
    with open(path) as f:
        return [int(line.strip()) for line in f]


def adjacency_from_dict(graph: dict[int, list[int]], n: int) -> sp.coo_matrix:
    """Binary symmetric adjacency from a dict of neighbour lists;
    duplicate edges collapse, self-loops stay (as the reference's
    ``nx.from_dict_of_lists`` path keeps them)."""
    rows, cols = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
            rows.append(v)
            cols.append(u)
    adj = sp.coo_matrix(
        (np.ones(len(rows), dtype=np.float32), (rows, cols)), shape=(n, n)
    ).tocsr()
    adj.data[:] = 1.0
    return adj.tocoo()


def load_citation(dataset: str = "cora", normalization: str = "AugNormAdj",
                  data_path: str | None = None, device=None) -> CitationData:
    """Load ``dataset`` from ``data_path`` (``utils.paths.data_dir``)
    onto ``device`` (``None`` -> the card; raises without one)."""
    dev = resolve_device(device)
    dataset = dataset.lower()
    root = data_dir(data_path)
    objs = {p: _load_pickle(root / f"ind.{dataset}.{p}")
            for p in PLANETOID_PARTS}
    x, y = objs["x"], objs["y"]
    tx, ty = objs["tx"], objs["ty"]
    allx, ally, graph = objs["allx"], objs["ally"], objs["graph"]

    test_idx_reorder = np.array(
        parse_index_file(root / f"ind.{dataset}.test.index"))
    test_idx_range = np.sort(test_idx_reorder)

    if dataset == "citeseer":
        # isolated test nodes are missing from tx/ty: place the known rows
        # at their positions and zero-fill the gaps
        full = range(test_idx_reorder.min(), test_idx_reorder.max() + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - test_idx_reorder.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - test_idx_reorder.min(), :] = ty
        ty = ty_ext

    features = np.asarray(sp.vstack((allx, tx)).todense(), dtype=np.float32)
    features[test_idx_reorder, :] = features[test_idx_range, :]

    n = features.shape[0]
    adj = symmetrize_max(adjacency_from_dict(graph, n))

    labels_onehot = np.vstack((ally, ty))
    labels_onehot[test_idx_reorder, :] = labels_onehot[test_idx_range, :]
    labels = labels_onehot.argmax(axis=1)

    adj_norm = fetch_normalization(normalization)(adj)
    features = row_normalize(features)

    return CitationData(
        graph=SparseGraph.from_scipy(adj_norm).to(dev),
        features=torch.as_tensor(features, device=dev),
        labels=torch.as_tensor(labels, dtype=torch.int64, device=dev),
        idx_train=np.arange(y.shape[0]),
        idx_val=np.arange(y.shape[0], y.shape[0] + 500),
        idx_test=test_idx_range,
        n_classes=int(labels_onehot.shape[1]),
    )
