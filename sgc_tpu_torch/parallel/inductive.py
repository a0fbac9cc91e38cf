"""Sharded inductive dual-adjacency propagation (the counterpart of
sgc_tpu/parallel/inductive.py).

The inductive Reddit flow computes two propagations: the full graph for
the eval features and the train-only sub-adjacency for the train
features (no test-node leakage). Each adjacency gets its own
:class:`PartitionedGraph` and exchange plan over its own row space, and
both read one feature store, sharded over "nodes".

The train propagation's input rows (``x[idx_train]``, re-padded to the
train partition) move from the ranks that own them in the full
partition to the ranks that own them in the train partition through one
equal-block all_to_all on the ranks' devices (the host plan
``train_send`` / ``train_recv``, built once with the partitions); each
row arrives once and is copied into place, so the train input is the
same bits as the sharded ``pad_node_rows(x[idx_train])``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.parallel.halo import build_halo
from sgc_tpu_torch.parallel.mesh import NODES_AXIS, Mesh
from sgc_tpu_torch.parallel.partition import pad_node_rows, partition_graph
from sgc_tpu_torch.parallel.spmm import propagate_sharded, shard_features


@dataclasses.dataclass
class DualPartition:
    """Two partition descriptors over one feature store, and the plan
    that moves the train rows between them.

    train_send: int64[P, P, M], train_send[p, q] = the local rows of the
                full partition's part p that go to part q of the train
                partition (padded with 0);
    train_recv: int64[P, P, M], where each of those rows lands in part
                q's train rows (-1 on padding).
    """

    full: object            # PartitionedGraph over all nodes
    train: object           # PartitionedGraph over train nodes
    full_halo: object
    train_halo: object
    idx_train: np.ndarray   # train node ids in full-graph numbering
    full_bd: object = None  # ShardedBlockDense plans (blockdense mode)
    train_bd: object = None
    train_send: np.ndarray | None = None
    train_recv: np.ndarray | None = None


def train_exchange_plan(idx_train: np.ndarray, full_rows: int,
                        train_rows: int, n_parts: int):
    """``(train_send, train_recv)`` for train row t = full row
    ``idx_train[t]``: from part ``idx_train[t] // full_rows`` to part
    ``t // train_rows``, slots in increasing t within each pair."""
    idx = np.asarray(idx_train, np.int64)
    t = np.arange(len(idx), dtype=np.int64)
    src, dst = idx // full_rows, t // train_rows
    pair = src * n_parts + dst
    order = np.argsort(pair, kind="stable")
    counts = np.bincount(pair, minlength=n_parts * n_parts)
    width = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.empty(len(idx), np.int64)
    slot[order] = np.arange(len(idx)) - starts[pair[order]]
    send = np.zeros((n_parts, n_parts, width), np.int64)
    recv = np.full((n_parts, n_parts, width), -1, np.int64)
    send[src, dst, slot] = idx - src * full_rows
    recv[src, dst, slot] = t - dst * train_rows
    return send, recv


def build_dual_partition(full_graph: SparseGraph, train_graph: SparseGraph,
                         idx_train: np.ndarray, n_parts: int,
                         formulation: str = "segment",
                         n_features: int | None = None,
                         row_block: int = 512,
                         stripe: int = 512) -> DualPartition:
    """Partition both adjacencies and build their exchange plans (host
    numpy; every rank reads its own part). ``formulation="blockdense"``
    also builds both block-dense plans; ``n_features`` (a rank's feature
    width) is then required for the admission."""
    pf = partition_graph(full_graph, n_parts, device=False)
    pt = partition_graph(train_graph, n_parts, device=False)
    hf = build_halo(pf, device=False)
    ht = build_halo(pt, device=False)
    full_bd = train_bd = None
    if formulation == "blockdense":
        if n_features is None:
            raise ValueError("blockdense needs n_features for admission")
        from sgc_tpu_torch.parallel.blockdense import build_sharded_blockdense

        full_bd = build_sharded_blockdense(
            pf, hf, n_features, row_block=row_block, stripe=stripe,
            device=False)
        train_bd = build_sharded_blockdense(
            pt, ht, n_features, row_block=row_block, stripe=stripe,
            device=False)
    elif formulation != "segment":
        raise ValueError(f"unknown formulation {formulation!r}")
    send, recv = train_exchange_plan(idx_train, pf.rows_per_part,
                                     pt.rows_per_part, n_parts)
    return DualPartition(full=pf, train=pt, full_halo=hf, train_halo=ht,
                         idx_train=np.asarray(idx_train), full_bd=full_bd,
                         train_bd=train_bd, train_send=send,
                         train_recv=recv)


def gather_train_rows(mesh: Mesh, dual: DualPartition,
                      x_tile: torch.Tensor) -> torch.Tensor:
    """This rank's tile of the train partition's input rows from its tile
    of the full store: one all_to_all over "nodes" on the device."""
    p = mesh.coords[NODES_AXIS]
    dev = x_tile.device
    send = torch.as_tensor(np.asarray(dual.train_send[p]).reshape(-1),
                           device=dev)
    recv = mesh.all_to_all(NODES_AXIS, x_tile.index_select(0, send))
    pos = np.asarray(dual.train_recv[:, p]).reshape(-1)
    live = np.flatnonzero(pos >= 0)
    out = x_tile.new_zeros((dual.train.rows_per_part, x_tile.shape[1]))
    return out.index_copy_(
        0, torch.as_tensor(pos[live], device=dev),
        recv.index_select(0, torch.as_tensor(live, device=dev)))


def inductive_dual_propagate(mesh: Mesh, dual: DualPartition, x,
                             degree: int) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``(eval_feats, train_feats)``: this rank's tiles of S^K X over the
    full graph (``[R_full, F / n_feat]``) and of the train subgraph's
    over the train rows (``[R_train, F / n_feat]``). ``x`` is the full
    raw ``[N, F]`` host matrix every rank holds."""
    x_full = shard_features(mesh, pad_node_rows(np.asarray(x, np.float32),
                                                dual.full.n_rows_padded))
    train_in = gather_train_rows(mesh, dual, x_full)
    eval_feats = propagate_sharded(mesh, dual.full, x_full, degree,
                                   halo=dual.full_halo,
                                   blockdense=dual.full_bd)
    train_feats = propagate_sharded(mesh, dual.train, train_in, degree,
                                    halo=dual.train_halo,
                                    blockdense=dual.train_bd)
    return eval_feats, train_feats
