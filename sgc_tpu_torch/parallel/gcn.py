"""Sharded two-layer GCN training (the counterpart of
sgc_tpu/parallel/gcn.py): replicated weights, row-sharded activations,
and the graph partitioned over the ("nodes", 1) mesh.

Each layer is the port's ``models/gcn.py`` math, a dense product and its
bias, then the sharded SpMM (``parallel/spmm.py::spmm_sharded``: the
halo plan or the block-dense plan, kernels A and B); its backward is the
hop's transpose on the same kernels with the exchanges in reverse
(``parallel/autograd.py``). The loss is the masked cross-entropy summed
over the rank's rows and divided by the global train count, so each
rank's parameter gradient is its rows' share of the true gradient; the
shares are summed over "nodes" in rank order, and every rank steps the
same replicated weights with ``torch.optim.Adam(weight_decay=...)``, as
``train/loops.py::train_gcn`` does.
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sgc_tpu_torch.models.gcn import GCN, init_gcn, params_from_jax
from sgc_tpu_torch.parallel.halo import build_halo
from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, Mesh, make_mesh
from sgc_tpu_torch.parallel.partition import (
    PartitionedGraph,
    pad_node_rows,
    partition_graph,
)
from sgc_tpu_torch.parallel.spmm import shard_features, spmm_sharded
from sgc_tpu_torch.parallel.train import place_node_targets

PARAMS = ("w1", "b1", "w2", "b2")


class ShardedGCNState(NamedTuple):
    """``params``: the GCN (replicated, on the rank's device);
    ``opt_state``: ``torch.optim.Adam``'s state of each parameter by name
    (empty before the first step)."""

    params: GCN
    opt_state: dict


def _check_mesh(mesh: Mesh, what: str) -> None:
    if mesh.shape[FEAT_AXIS] != 1:
        raise ValueError(
            f"{what} needs a ('nodes', 1) mesh: hidden widths "
            "change per layer, so the feature axis must stay unsharded "
            f"(got feat axis size {mesh.shape[FEAT_AXIS]})")


def gcn_apply_sharded(mesh: Mesh, pgraph: PartitionedGraph, params: GCN,
                      x: torch.Tensor, halo=None, blockdense=None,
                      use_relu: bool = True,
                      precision: str = "bf16") -> torch.Tensor:
    """This rank's logits rows: ``S (relu(S (x w1 + b1)) w2 + b2)`` with
    both SpMMs sharded (``precision`` for a block-dense plan, whose
    default is the reference's)."""
    _check_mesh(mesh, "gcn_apply_sharded")
    kw = dict(halo=halo, blockdense=blockdense, precision=precision)
    h = spmm_sharded(mesh, pgraph, x @ params.w1 + params.b1, **kw)
    if use_relu:
        h = torch.relu(h)
    return spmm_sharded(mesh, pgraph, h @ params.w2 + params.b2, **kw)


def init_sharded_gcn(mesh: Mesh, generator: torch.Generator,
                     n_features: int, n_hidden: int,
                     n_classes: int) -> ShardedGCNState:
    """A new GCN drawn from ``generator`` (seeded alike on every rank) on
    the rank's device, with no optimizer state yet."""
    return ShardedGCNState(
        params=init_gcn(generator, n_features, n_hidden, n_classes,
                        device=mesh.device),
        opt_state={k: {} for k in PARAMS})


def make_sharded_gcn_step(mesh: Mesh, pgraph: PartitionedGraph, *,
                          lr: float = 0.01, weight_decay: float = 5e-4,
                          halo=None, blockdense=None,
                          precision: str = "bf16"):
    """``step(state, x, labels, mask) -> (state, loss)`` over the mesh,
    ``x`` this rank's ``[R, F]`` rows, ``labels`` / ``mask`` its rows of
    the targets (``parallel/train.py::place_node_targets``); ``loss`` is
    the global masked mean (the same on every rank) and ``state`` is
    updated in place. Every rank runs the forward and the backward, so
    their collectives line up."""
    _check_mesh(mesh, "make_sharded_gcn_step")

    def step(state: ShardedGCNState, x, labels, mask):
        model = state.params
        params = [getattr(model, k) for k in PARAMS]
        with torch.no_grad():
            denom = mesh.all_reduce(NODES_AXIS, mask.sum())
        logits = gcn_apply_sharded(mesh, pgraph, model, x, halo=halo,
                                   blockdense=blockdense,
                                   precision=precision)
        local = (F.cross_entropy(logits, labels, reduction="none")
                 * mask).sum()
        grads = torch.autograd.grad(local / denom, params)
        for p, g in zip(params, grads):
            p.grad = mesh.sum_in_order(NODES_AXIS, g)
        loss = mesh.sum_in_order(NODES_AXIS, local.detach()) / denom
        opt = torch.optim.Adam([{"params": params,
                                 "weight_decay": weight_decay}], lr=lr)
        for k, p in zip(PARAMS, params):
            opt.state[p] = state.opt_state[k]
        opt.step()
        for p in params:
            p.grad = None
        return state, loss

    return step


def fit_gcn_sharded(graph, features: np.ndarray, labels: np.ndarray,
                    idx_train: np.ndarray, n_classes: int, *,
                    mesh: Mesh | None = None, n_hidden: int = 16,
                    epochs: int = 100, lr: float = 0.01,
                    weight_decay: float = 5e-4, seed: int = 42,
                    use_halo: bool = True, init_params=None,
                    pgraph: PartitionedGraph | None = None, halo=None):
    """One-call distributed GCN fit on every rank of ``mesh`` (default:
    every rank of the world on "nodes"). Returns ``(GCN, losses)``, the
    GCN replicated on the rank's device.

    ``use_halo``: the overlapped halo plan, else the all-gather. Port
    additions: ``init_params`` (a GCN, a dict of arrays ``w1``, ``b1``,
    ``w2``, ``b2``, or anything with them as attributes, such as the
    reference's ``GCNParams``) replaces
    the draw from ``torch.Generator().manual_seed(seed)``; ``pgraph`` /
    ``halo`` replace the plans this call would build.
    """
    if mesh is None:
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        mesh = make_mesh(world, 1)
    if mesh.shape[FEAT_AXIS] != 1:
        raise ValueError("fit_gcn_sharded needs a ('nodes', 1) mesh")
    if pgraph is None:
        pgraph = partition_graph(graph, mesh.shape[NODES_AXIS], device=False)
    if use_halo and halo is None:
        halo = build_halo(pgraph, overlap=True, device=False)
    if not use_halo:
        halo = None
    x = shard_features(mesh, pad_node_rows(
        np.asarray(features, np.float32), pgraph.n_rows_padded))
    y, m = place_node_targets(mesh, pgraph.n_rows_padded, labels, idx_train)
    if init_params is None:
        state = init_sharded_gcn(mesh, torch.Generator().manual_seed(seed),
                                 int(x.shape[1]), n_hidden, n_classes)
    else:
        if isinstance(init_params, GCN):
            init_params = {k: getattr(init_params, k).detach().cpu().numpy()
                           for k in PARAMS}
        if isinstance(init_params, dict):
            init_params = types.SimpleNamespace(**init_params)
        state = ShardedGCNState(
            params=params_from_jax(init_params, device=mesh.device),
            opt_state={k: {} for k in PARAMS})
    step = make_sharded_gcn_step(mesh, pgraph, lr=lr,
                                 weight_decay=weight_decay, halo=halo)
    losses, pending = [], []
    for i in range(epochs):
        state, loss = step(state, x, y, m)
        pending.append(loss)
        if (i + 1) % 16 == 0 or i + 1 == epochs:
            losses.extend(torch.stack(pending).cpu().tolist())
            pending = []
    return state.params.requires_grad_(False), losses
