"""Sharded full-batch SGC training step over the ("nodes", "feat") mesh
(the counterpart of sgc_tpu/parallel/train.py).

Per rank:
  x      [R, F / n_feat]   its node rows and feature columns
  W      [F / n_feat, C]   its rows of the tensor-parallel head
  b      [C]               replicated
  labels, mask [R]         its rows (mask 1.0 on train rows, 0 on the
                           rest and on padding)

One step = K sharded hops (``parallel/spmm.py``: kernel B, or kernels A
and B for a block-dense plan) -> the matmul on the head's shard ->
logits summed over "feat" -> masked cross-entropy, its denominator
summed over "nodes" -> dW and db summed over "nodes" ->
``torch.optim.Adam`` with ``weight_decay`` (classic L2 added to the
gradient, as ``train/loops.py::_adam_steps`` uses it; the reference's
``torch_adam``).

The gradient is the true one on any mesh: the "feat" sum passes the
loss's gradient once to each shard (:class:`_SumOver`), and the "nodes"
sums are taken by hand after ``autograd.grad``, so a (2, 2) step equals
a (1, 1) step up to f32 rounding. (The reference's ``psum`` inside
``value_and_grad`` under ``check_vma=False`` transposes to another
``psum``, which scales its dW by n_nodes * n_feat and its db by n_nodes;
Adam hides most of that, weight decay does not. ROADMAP queue 3.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sgc_tpu_torch.models.sgc import SGC
from sgc_tpu_torch.parallel.distributed import _tile_slices, put_global
from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, Mesh
from sgc_tpu_torch.parallel.partition import PartitionedGraph
from sgc_tpu_torch.parallel.spmm import spmm_sharded


def place_node_targets(mesh: Mesh, n_rows_padded: int, labels, idx_train):
    """This rank's (labels int64, mask f32) rows of the labels and the
    train mask, zero-padded to the partition row space."""
    y = np.zeros(n_rows_padded, np.int64)
    y[: len(labels)] = np.asarray(labels, np.int64)
    m = np.zeros(n_rows_padded, np.float32)
    m[np.asarray(idx_train)] = 1.0
    return (put_global(mesh, (NODES_AXIS,), y),
            put_global(mesh, (NODES_AXIS,), m))


class ShardedTrainState(NamedTuple):
    """``params``: an SGC head holding this rank's W rows and b;
    ``opt_state``: ``torch.optim.Adam``'s state of each, ``{"w": {...},
    "b": {...}}`` with ``step``, ``exp_avg`` and ``exp_avg_sq``."""

    params: SGC
    opt_state: dict


def state_from_arrays(mesh: Mesh, w, b, mu_w, mu_b, nu_w, nu_b,
                      count: int) -> ShardedTrainState:
    """This rank's state from full host arrays every rank holds: W and
    its moments cut to the rank's "feat" rows, b and its moments whole,
    ``count`` steps taken."""
    rows = _tile_slices(mesh, (FEAT_AXIS, None), np.shape(w))

    def t(a, cut=False):
        a = np.asarray(a, np.float32)
        return torch.tensor(a[rows] if cut else a, device=mesh.device)

    def adam(mu, nu, cut):
        return {"step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": t(mu, cut), "exp_avg_sq": t(nu, cut)}

    return ShardedTrainState(
        params=SGC(t(w, True), t(b)),
        opt_state={"w": adam(mu_w, nu_w, True), "b": adam(mu_b, nu_b,
                                                          False)})


def state_arrays(state) -> dict:
    """The arrays of the reference's ``ShardedTrainState`` (params w, b;
    the Adam entry of its optax chain: count, mu, nu), as numpy, in
    :func:`state_from_arrays`'s keywords. Reads attributes only, so the
    port imports nothing of the reference."""
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    return {"w": np.asarray(state.params.w), "b": np.asarray(state.params.b),
            "mu_w": np.asarray(adam.mu.w), "mu_b": np.asarray(adam.mu.b),
            "nu_w": np.asarray(adam.nu.w), "nu_b": np.asarray(adam.nu.b),
            "count": int(np.asarray(adam.count))}


def sharded_state_from_jax(state, mesh: Mesh) -> ShardedTrainState:
    """This rank's shard of the reference's ``ShardedTrainState``: its W
    rows, b, and the Adam state ``torch.optim.Adam`` keeps (``exp_avg``
    = mu, ``exp_avg_sq`` = nu, ``step`` = count). ``state`` is the
    reference's state with numpy leaves or :func:`state_arrays`'s dict
    (what a spawned rank receives). The moments carry over as they are,
    so a reference state stepped on a mesh larger than (1, 1) brings its
    scaled moments along (module docstring)."""
    arrays = state if isinstance(state, dict) else state_arrays(state)
    return state_from_arrays(mesh, **arrays)


def init_sharded_state(mesh: Mesh, generator: torch.Generator,
                       n_features: int, n_classes: int) -> ShardedTrainState:
    """A new head drawn from ``generator`` (a CPU generator seeded alike on
    every rank: w, then b, U(-1/sqrt(F), 1/sqrt(F))) with zero moments."""
    bound = 1.0 / float(np.sqrt(n_features))
    w = torch.empty((n_features, n_classes)).uniform_(-bound, bound,
                                                      generator=generator)
    b = torch.empty((n_classes,)).uniform_(-bound, bound,
                                           generator=generator)
    zw, zb = np.zeros(w.shape, np.float32), np.zeros(b.shape, np.float32)
    return state_from_arrays(mesh, w.numpy(), b.numpy(), zw, zb, zw, zb, 0)


class _SumOver(torch.autograd.Function):
    """Sum over a mesh axis whose ranks all compute the same loss from the
    sum: the forward all-reduces, the backward passes the gradient on
    unchanged (each rank's partial gets the loss's gradient once)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(axis, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def make_sharded_train_step(
    mesh: Mesh,
    pgraph: PartitionedGraph,
    *,
    degree: int = 0,
    lr: float = 0.2,
    weight_decay: float = 0.0,
    halo=None,
    blockdense=None,
    precision: str = "bf16",
):
    """The step closed over the partitioned graph: ``step(state, x,
    labels, mask) -> (state, loss)``, ``loss`` the global masked mean
    (the same on every rank). ``state`` is updated in place.

    ``degree > 0`` runs the K hops inside the step (``spmm_sharded`` with
    ``halo`` / ``blockdense`` / the all-gather, ``precision`` for the
    block-dense plan); ``degree == 0`` consumes propagated features.
    """
    def step(state: ShardedTrainState, x, labels, mask):
        with torch.no_grad():
            for _ in range(degree):
                x = spmm_sharded(mesh, pgraph, x, halo=halo,
                                 blockdense=blockdense, precision=precision)
            denom = mesh.all_reduce(NODES_AXIS, mask.sum())
        w, b = state.params.w, state.params.b
        logits = _SumOver.apply(x @ w, mesh, FEAT_AXIS) + b
        local = (F.cross_entropy(logits, labels, reduction="none")
                 * mask).sum()
        gw, gb = torch.autograd.grad(local / denom, [w, b])
        # dW, db from this rank's rows only: the data-parallel sum
        w.grad = mesh.all_reduce(NODES_AXIS, gw)
        b.grad = mesh.all_reduce(NODES_AXIS, gb)
        loss = mesh.all_reduce(NODES_AXIS, local.detach()) / denom
        opt = torch.optim.Adam([{"params": [w, b],
                                 "weight_decay": weight_decay}], lr=lr)
        opt.state[w] = state.opt_state["w"]
        opt.state[b] = state.opt_state["b"]
        opt.step()
        w.grad = b.grad = None
        return state, loss

    return step
