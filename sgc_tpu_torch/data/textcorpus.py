"""Text-corpus dataset loader, TextSGC format (the counterpart of
sgc_tpu/data/textcorpus.py).

Per-phase id and label pickles ``ind.<ds>.{train,val,test}.{x,y}`` (or
``ind.<ds>.<fold>.<phase>.{x,y}`` for a cross-validation fold) and the
doc-word adjacency ``ind.<ds>.<subset>.adj``, normalized as
``D^-1/2 (A + I) D^-1/2`` on the host, bit for bit the reference's. The
graph is placed on the requested device; the index and label arrays stay
numpy.

The pickles are unpickled as the format requires: load only dataset
files from a trusted source.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np

from sgc_tpu_torch.graph.normalize import sym_normalized_adjacency_selfloops
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.paths import data_dir


@dataclasses.dataclass(frozen=True)
class TextCorpusData:
    graph: SparseGraph                 # normalized doc-word adjacency
    index_dict: dict[str, np.ndarray]  # node ids per phase (docs only)
    label_dict: dict[str, np.ndarray]  # int labels per phase
    n_classes: int
    n_nodes: int


def _load_pickle(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def load_corpus(dataset: str, subset: str = "BCD",
                data_path: str | None = None, fold: int | None = None,
                device=None) -> TextCorpusData:
    """Load a text-graph dataset onto ``device`` (``None`` -> the card);
    ``fold`` selects a cross-validation fold."""
    dev = resolve_device(device)
    root = data_dir(data_path)

    index_dict, label_dict = {}, {}
    for phase in ("train", "val", "test"):
        stem = (f"ind.{dataset}.{fold}.{phase}" if fold is not None
                else f"ind.{dataset}.{phase}")
        index_dict[phase] = np.asarray(_load_pickle(root / f"{stem}.x"))
        label_dict[phase] = np.asarray(_load_pickle(root / f"{stem}.y"))

    adj = _load_pickle(root / f"ind.{dataset}.{subset}.adj").astype(
        np.float32)
    graph = SparseGraph.from_scipy(
        sym_normalized_adjacency_selfloops(adj)).to(dev)

    n_classes = 1 + int(max(
        label_dict[p].max() for p in label_dict if label_dict[p].size))
    return TextCorpusData(graph=graph, index_dict=index_dict,
                          label_dict=label_dict, n_classes=n_classes,
                          n_nodes=adj.shape[0])
