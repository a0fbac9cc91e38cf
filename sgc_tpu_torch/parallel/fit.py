"""High-level distributed SGC training: one call from graph to fitted
head (the counterpart of sgc_tpu/parallel/fit.py).

    params, report = fit_sharded(graph, X, y, idx_train, n_classes,
                                 mesh=mesh)

Every rank of the mesh calls it with the same full host inputs and
keeps its own tiles. The SGC factorization holds: the features are
propagated once through the sharded hops (``propagate_sharded``), then
every epoch is the head's step on the propagated tiles
(``make_sharded_train_step`` with degree 0).

The host plans (partition, halo plan, block-dense plan) come from
:func:`plan_fit`; a caller that runs several fits on one graph builds
them once and passes ``plan=`` (every rank can read them from files:
:func:`save_fit_plan` / :func:`load_fit_plan`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models.sgc import SGC
from sgc_tpu_torch.parallel.distributed import (
    _tile_slices,
    fetch_global,
    load_host,
    save_host,
)
from sgc_tpu_torch.parallel.halo import build_halo, halo_fraction
from sgc_tpu_torch.parallel.mesh import (
    FEAT_AXIS,
    NODES_AXIS,
    Mesh,
    default_mesh_shape,
    make_mesh,
)
from sgc_tpu_torch.parallel.partition import (
    _round_up,
    pad_feature_dim,
    pad_node_rows,
    partition_graph,
)
from sgc_tpu_torch.parallel.spmm import propagate_sharded, shard_features
from sgc_tpu_torch.parallel.staging import is_provider, stage_rows
from sgc_tpu_torch.parallel.train import (
    ShardedTrainState,
    init_sharded_state,
    make_sharded_train_step,
    place_node_targets,
    sharded_state_from_jax,
)

FORMULATIONS = ("auto", "blockdense", "segment")
TRAINERS = ("adam", "newton")
# sharding of each leaf of the flattened train state
_STATE_SPECS = {"w": (FEAT_AXIS, None), "w.exp_avg": (FEAT_AXIS, None),
                "w.exp_avg_sq": (FEAT_AXIS, None)}


def _flatten_state(state: ShardedTrainState) -> dict:
    out = {"w": state.params.w.detach(), "b": state.params.b.detach()}
    for name, st in state.opt_state.items():
        for k, v in st.items():
            out[f"{name}.{k}"] = v
    return out


def _unflatten_state(flat: dict) -> ShardedTrainState:
    opt = {name: {k: flat[f"{name}.{k}"]
                  for k in ("step", "exp_avg", "exp_avg_sq")}
           for name in ("w", "b")}
    return ShardedTrainState(params=SGC(flat["w"], flat["b"]), opt_state=opt)


class _FitCheckpointer:
    """Sharded train-state checkpoints for :func:`fit_sharded` (params,
    Adam's ``step`` / ``exp_avg`` / ``exp_avg_sq``, exactly).

    The reference's crash-safety contract: state goes to an epoch-tagged
    directory (``state_<epoch>``, every rank its tiles through
    ``utils.checkpoint.save_sharded``), then rank 0 alone writes
    ``meta.json`` (tmp + rename) naming that epoch, so a preemption
    between the two leaves the previous consistent pair in force. The
    fingerprint (run configuration and data identity) is checked on
    restore; a mismatched or unreadable checkpoint gives a warning and a
    fresh start, never a crash loop.
    """

    def __init__(self, directory, fingerprint: str, mesh: Mesh):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fingerprint = fingerprint
        self.mesh = mesh

    def save(self, state: ShardedTrainState, epoch: int,
             losses: list) -> None:
        from sgc_tpu_torch.utils.checkpoint import save_sharded

        state_dir = self.dir / f"state_{epoch}"
        save_sharded(state_dir, _flatten_state(state), self.mesh,
                     _STATE_SPECS)
        if self.mesh.rank == 0:
            tmp = self.dir / "meta.json.tmp"
            tmp.write_text(json.dumps({
                "epoch": epoch, "losses": losses,
                "fingerprint": self.fingerprint}))
            tmp.replace(self.dir / "meta.json")
            # older state directories are garbage once meta points past
            for p in self.dir.glob("state_*"):
                if p != state_dir:
                    shutil.rmtree(p, ignore_errors=True)
        # no rank restores or saves again before meta names this epoch
        self.mesh.barrier()

    def restore(self, like: ShardedTrainState):
        """``(state, epoch, losses)`` from the latest consistent save, or
        None (missing, another run's, or unreadable)."""
        from sgc_tpu_torch.utils.checkpoint import load_sharded

        meta_p = self.dir / "meta.json"
        if not meta_p.exists():
            return None
        try:
            meta = json.loads(meta_p.read_text())
            if meta.get("fingerprint") != self.fingerprint:
                warnings.warn(
                    f"{self.dir}: checkpoint belongs to a different run "
                    "(fingerprint mismatch) — starting fresh",
                    stacklevel=3)
                return None
            flat = load_sharded(self.dir / f"state_{meta['epoch']}",
                                like=_flatten_state(like), mesh=self.mesh)
            return (_unflatten_state(flat), int(meta["epoch"]),
                    list(meta["losses"]))
        except Exception as exc:
            # a boundary that must keep running: any unreadable state
            # is reported and the fit starts fresh
            warnings.warn(
                f"{self.dir}: unreadable checkpoint "
                f"({type(exc).__name__}: {exc}) — starting fresh",
                stacklevel=3)
            return None


@dataclasses.dataclass
class FitReport:
    loss_history: list
    train_accuracy: float
    n_devices: int
    n_parts: int
    halo_fraction: float
    formulation: str = "segment"
    dense_fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class FitPlan:
    """The host plans of one fit: the partition, the halo plan (None for
    the all-gather) and the block-dense plan (None for the segment
    formulation), with what was decided and why."""

    pgraph: object
    halo: object
    blockdense: object
    halo_fraction: float
    formulation: str
    dense_fraction: float


def plan_fit(graph: SparseGraph, n_parts: int, n_feat_parts: int,
             n_features: int, *, use_halo: bool | None = True,
             formulation: str = "auto", row_block: int = 512,
             stripe: int = 512, edge_chunk: int | None = None,
             col_chunk: int | None = None) -> FitPlan:
    """The reference's plan choice (host numpy, every array bit for bit
    the reference's):

    * ``formulation="blockdense"``: the plain halo plan and the
      block-dense plan (overrides ``use_halo=False``);
    * else ``use_halo`` True = the halo exchange, False = the all-gather,
      None = size a plain plan first and take the halo when its fraction
      is below 0.5; ``"auto"`` then means block-dense with the halo,
      unless ``edge_chunk`` or ``col_chunk`` asks for memory-bounded
      segment hops; the segment halo plan is overlapped unless they do.

    ``n_features`` is the unpadded feature width; the block-dense
    admission sees a rank's padded share, as the reference's does.
    """
    from sgc_tpu_torch.parallel.blockdense import build_sharded_blockdense

    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation {formulation!r}")
    pgraph = partition_graph(graph, n_parts, device=False)
    if formulation == "blockdense":
        halo = build_halo(pgraph, device=False)
        frac = halo_fraction(halo, pgraph)
    else:
        sizing = None
        if use_halo is None:
            sizing = build_halo(pgraph, device=False)
            frac = halo_fraction(sizing, pgraph)
            want_halo = frac < 0.5
        else:
            want_halo = bool(use_halo)
            frac = None
        if formulation == "auto":
            formulation = ("blockdense" if want_halo and not edge_chunk
                           and not col_chunk else "segment")
        if not want_halo:
            halo = None
            if frac is None:
                frac = 1.0
        elif formulation == "blockdense":
            halo = sizing if sizing is not None else build_halo(
                pgraph, device=False)
        else:
            halo = build_halo(pgraph, overlap=not (edge_chunk or col_chunk),
                              device=False)
        if frac is None:
            frac = halo_fraction(halo, pgraph)
    bd = None
    dense_fraction = 0.0
    if formulation == "blockdense":
        f_pad = _round_up(int(n_features), 8 * n_feat_parts)
        bd = build_sharded_blockdense(pgraph, halo, f_pad // n_feat_parts,
                                      row_block=row_block, stripe=stripe,
                                      device=False)
        dense_fraction = bd.dense_fraction
    return FitPlan(pgraph, halo, bd, float(frac), formulation,
                   float(dense_fraction))


def save_fit_plan(path, plan: FitPlan) -> None:
    """Write ``plan`` under directory ``path`` (one ``save_host``
    directory per host plan, and the scalars)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    for name in ("pgraph", "halo", "blockdense"):
        if getattr(plan, name) is not None:
            save_host(path / name, getattr(plan, name))
    (path / "fit_plan.json").write_text(json.dumps({
        "halo_fraction": plan.halo_fraction,
        "formulation": plan.formulation,
        "dense_fraction": plan.dense_fraction}))


def load_fit_plan(path) -> FitPlan:
    """The plan :func:`save_fit_plan` wrote (arrays memory-mapped)."""
    path = Path(path)
    parts = {name: load_host(path / name) if (path / name).exists()
             else None for name in ("pgraph", "halo", "blockdense")}
    return FitPlan(**parts, **json.loads(
        (path / "fit_plan.json").read_text()))


def _fingerprint(graph, n_features, n_classes, degree, lr, weight_decay,
                 seed, formulation, n_parts, n_feat_parts, reorder,
                 row_block, stripe, edge_chunk, col_chunk) -> str:
    """The reference's tuple, hashed as the reference hashes it."""
    return hashlib.sha256(repr((
        "fit_sharded_v1", graph.nnz, graph.n_rows, int(n_features),
        n_classes, degree, lr, weight_decay, seed, formulation, n_parts,
        n_feat_parts, reorder, row_block, stripe, edge_chunk, col_chunk,
    )).encode()).hexdigest()[:16]


def fit_sharded(
    graph: SparseGraph,
    features,
    labels: np.ndarray,
    idx_train: np.ndarray,
    n_classes: int,
    *,
    mesh: Mesh | None = None,
    degree: int = 2,
    epochs: int = 100,
    lr: float = 0.2,
    weight_decay: float = 5e-6,
    seed: int = 42,
    use_halo: bool | None = True,
    reorder: str | None = None,
    formulation: str = "auto",
    row_block: int = 512,
    stripe: int = 512,
    checkpoint_dir: str | None = None,
    save_every: int = 25,
    edge_chunk: int | None = None,
    col_chunk: int | None = None,
    trainer: str = "adam",
    newton_steps: int = 8,
    init_state=None,
    plan: FitPlan | None = None,
):
    """Distributed SGC fit; returns ``(SGC head with the full W and b on
    the mesh's device, FitReport)`` on every rank.

    The reference's arguments, with its branches and errors:
    ``formulation`` / ``use_halo`` / ``edge_chunk`` / ``col_chunk`` as
    :func:`plan_fit`; ``reorder`` (a graph/reorder.py name, e.g. "lpa")
    before partitioning, labels, features and idx_train travelling with
    their nodes (a row provider cannot be reordered lazily and raises);
    ``features`` an ndarray or a row provider (``parallel/staging.py``:
    each rank stages only its tile); ``trainer`` "adam" (epochs of the
    sharded step, checkpointed every ``save_every`` epochs into
    ``checkpoint_dir`` and resumed from there) or "newton" (the
    Böhning/MM fit of ``train/optim.py`` on the sharded features; it
    rejects ``checkpoint_dir``).

    Port additions: ``init_state`` (a ``ShardedTrainState`` or the full
    arrays of ``parallel/train.py::state_arrays``) replaces the head drawn
    from ``torch.Generator().manual_seed(seed)``, so a test can start
    from the reference's; ``plan`` (from :func:`plan_fit` on the graph as
    given) replaces the plan this call would build. Losses stay on the
    device and are read every 16 epochs.
    """
    staged = is_provider(features)
    if reorder is not None:
        if staged:
            raise ValueError(
                "reorder= needs to permute feature rows, which a staged "
                "row provider cannot do lazily — pre-permute the provider "
                "(compose it with the permutation) or pass an ndarray")
        if plan is not None:
            raise ValueError("plan= is built on the graph as given; "
                             "reorder= would change the graph under it")
        from sgc_tpu_torch.graph.reorder import reorder_graph_arrays

        graph, features, labels, idx_train, _ = reorder_graph_arrays(
            graph, reorder, features, labels, idx_train)
    if mesh is None:
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        mesh = make_mesh(*default_mesh_shape(world))
    n_parts, n_feat_parts = mesh.shape[NODES_AXIS], mesh.shape[FEAT_AXIS]
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation {formulation!r}")
    if trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {trainer!r}")
    if trainer == "newton" and checkpoint_dir:
        raise ValueError("checkpoint_dir applies to the adam epoch loop; "
                         "the newton fit is a single short program")
    n_features = int(np.shape(features)[1])
    if plan is None:
        plan = plan_fit(graph, n_parts, n_feat_parts, n_features,
                        use_halo=use_halo, formulation=formulation,
                        row_block=row_block, stripe=stripe,
                        edge_chunk=edge_chunk, col_chunk=col_chunk)
    pgraph = plan.pgraph
    if pgraph.n_parts != n_parts:
        raise ValueError(f"plan has {pgraph.n_parts} parts, mesh nodes "
                         f"axis is {n_parts}")

    if staged:
        x = stage_rows(mesh, features, n_rows_padded=pgraph.n_rows_padded)
    else:
        x = np.asarray(features, np.float32)
        x = pad_node_rows(pad_feature_dim(x, 8 * n_feat_parts),
                          pgraph.n_rows_padded)
        x = shard_features(mesh, x)
    f_pad = int(x.shape[1]) * n_feat_parts
    # the consume form: no frame here keeps the hop-0 input alive
    xbox = [x]
    del x
    x = propagate_sharded(mesh, pgraph, xbox, degree, halo=plan.halo,
                          blockdense=plan.blockdense, edge_chunk=edge_chunk,
                          col_chunk=col_chunk, sync_each_hop=True)
    y, m = place_node_targets(mesh, pgraph.n_rows_padded, labels, idx_train)

    if init_state is None:
        state = init_sharded_state(mesh, torch.Generator().manual_seed(seed),
                                   f_pad, n_classes)
    elif isinstance(init_state, dict):
        state = sharded_state_from_jax(init_state, mesh)
    else:
        state = init_state

    if trainer == "newton":
        w, b, losses = _newton(mesh, state, x, y, m, weight_decay,
                               newton_steps)
    else:
        w, b, losses = _adam_epochs(
            mesh, pgraph, state, x, y, m, epochs=epochs, lr=lr,
            weight_decay=weight_decay, save_every=save_every,
            checkpoint_dir=checkpoint_dir, fingerprint=lambda: _fingerprint(
                graph, n_features, n_classes, degree, lr, weight_decay,
                seed, plan.formulation, n_parts, n_feat_parts, reorder,
                row_block, stripe, edge_chunk, col_chunk))
    params = SGC(w, b).requires_grad_(False)
    return params, _finish(mesh, x, params, labels, idx_train, losses, plan)


def _newton(mesh: Mesh, state, x, y, m, weight_decay: float, steps: int):
    """The Böhning/MM fit on the sharded features. Each rank joins its
    "nodes" group's feature columns (an all-gather over "feat"), so it
    holds its rows at full width; the fit's sums over rows are completed
    over "nodes" in rank order (``Mesh.sum_in_order``), so every rank
    takes the same steps to the same (replicated) head."""
    from sgc_tpu_torch.train.optim import newton_linear_fit

    x_rows = mesh.all_gather(FEAT_AXIS, x, dim=1)
    w0 = mesh.all_gather(FEAT_AXIS, state.params.w.detach(), dim=0)
    b0 = state.params.b.detach()
    w, b, loss = newton_linear_fit(
        w0, b0, x_rows, y, weight_decay, sample_weights=m, steps=steps,
        row_sum=lambda t: mesh.sum_in_order(NODES_AXIS, t))
    return w, b, [float(loss)]


def _adam_epochs(mesh, pgraph, state, x, y, m, *, epochs, lr, weight_decay,
                 save_every, checkpoint_dir, fingerprint):
    """The Adam epochs from ``state`` (or the checkpoint's), with
    checkpoints; returns (full W, b, the loss of every epoch)."""
    step = make_sharded_train_step(mesh, pgraph, degree=0, lr=lr,
                                   weight_decay=weight_decay)
    start_epoch, host_losses, ckpt = 0, [], None
    if checkpoint_dir:
        ckpt = _FitCheckpointer(checkpoint_dir, fingerprint(), mesh)
        restored = ckpt.restore(state)
        if restored is not None:
            r_state, r_epoch, r_losses = restored
            if r_epoch <= epochs:
                state, start_epoch, host_losses = r_state, r_epoch, r_losses
            else:
                warnings.warn(
                    f"{checkpoint_dir}: saved epoch {r_epoch} exceeds the "
                    f"requested {epochs} — ignoring the checkpoint",
                    stacklevel=3)
    pending = []                      # device losses since the last read
    for i in range(start_epoch, epochs):
        state, loss = step(state, x, y, m)
        pending.append(loss)
        saving = ckpt is not None and (i + 1) % save_every == 0
        if (i + 1) % 16 == 0 or i + 1 == epochs or saving:
            host_losses.extend(torch.stack(pending).cpu().tolist())
            pending = []
        if saving and i + 1 < epochs:
            ckpt.save(state, i + 1, host_losses)
    if ckpt is not None:
        ckpt.save(state, epochs, host_losses)
    w = mesh.all_gather(FEAT_AXIS, state.params.w.detach(), dim=0)
    return w, state.params.b.detach().clone(), host_losses


def _finish(mesh: Mesh, x, params: SGC, labels, idx_train, losses,
            plan: FitPlan) -> FitReport:
    """The training accuracy from the sharded features, and the report."""
    w = params.w[_tile_slices(mesh, (FEAT_AXIS, None), tuple(params.w.shape))]
    with torch.no_grad():
        logits = mesh.sum_in_order(FEAT_AXIS, x @ w) + params.b
    preds = fetch_global(mesh, logits.argmax(dim=1), (NODES_AXIS,))
    idx = np.asarray(idx_train)
    train_acc = float(
        (preds[idx] == np.asarray(labels, np.int64)[idx]).mean())
    return FitReport(
        loss_history=list(losses), train_accuracy=train_acc,
        n_devices=mesh.size, n_parts=mesh.shape[NODES_AXIS],
        halo_fraction=plan.halo_fraction, formulation=plan.formulation,
        dense_fraction=plan.dense_fraction)
