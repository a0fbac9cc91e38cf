"""The ("nodes", "feat") mesh of ranks (the counterpart of
sgc_tpu/parallel/mesh.py) and its collectives.

Axes, as in the reference:
  "nodes" -- graph rows are block-partitioned over this axis; each rank
             owns a contiguous row range of S and the matching feature
             rows. It is also the data-parallel axis of the head's step.
  "feat"  -- the tensor-parallel axis: the head's weight is row-sharded
             over the feature dimension, logits summed over this axis.

Each rank is one process; rank ``r`` of a mesh sits at node ``r // n_feat``
and feat ``r % n_feat`` (the reference's grid order). A rank calls every
sharded function with its own tile and gets its own tile back.

The transport is named by the caller, never guessed, and never switched
when something fails:

* ``"nccl"``: every tensor stays on its card. NCCL refuses two ranks of
  one communicator on one card, so a mesh with more ranks than cards
  raises at once.
* ``"gloo"``: on a CUDA rank each collective copies its packed buffer to
  pinned host memory, runs the gloo collective there and copies the
  result back (:meth:`Mesh._to_wire`, the one place that does it); CPU
  tensors go to gloo directly.

A (1, 1) mesh in a process with no process group runs every collective
as the identity (the reference's "all code paths degrade to local
compute"); in an initialized world even a size-1 axis runs its
collective through the transport.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from sgc_tpu_torch.utils.device import rank_device

NODES_AXIS = "nodes"
FEAT_AXIS = "feat"
TRANSPORTS = ("nccl", "gloo")


class Pending:
    """A started collective: :meth:`wait` returns its result on the
    device the input came from."""

    def __init__(self, work, out: torch.Tensor, device: torch.device):
        self._work, self._out, self._device = work, out, device

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        if self._out.device == self._device:
            return self._out
        return self._out.to(self._device, non_blocking=True)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a mesh: the axis sizes (``shape``), its world
    rank and coordinates, one process group per axis (the ranks that
    differ only in that axis's coordinate; None without a process
    group), its device and the transport."""

    shape: dict
    rank: int
    coords: dict
    groups: dict
    device: torch.device
    transport: str | None

    @property
    def size(self) -> int:
        return self.shape[NODES_AXIS] * self.shape[FEAT_AXIS]

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """What the collective sends: ``t`` itself, or for gloo on a CUDA
        rank a copy in pinned host memory (the copy waits for ``t``)."""
        t = t.contiguous()
        if self.transport != "gloo" or t.device.type != "cuda":
            return t
        wire = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        wire.copy_(t)
        return wire

    def all_to_all(self, axis: str, send: torch.Tensor,
                   async_op: bool = False):
        """Equal-block all_to_all over ``axis``: block q of ``send`` (dim
        0 cut in ``shape[axis]`` equal blocks) goes to the axis's q-th
        rank, and block q of the result came from it. With ``async_op``
        returns a :class:`Pending`."""
        g = self.groups[axis]
        if g is None:
            done = Pending(None, send, send.device)
            return done if async_op else done.wait()
        wire = self._to_wire(send)
        recv = torch.empty(wire.shape, dtype=wire.dtype, device=wire.device,
                           pin_memory=wire.is_pinned())
        work = dist.all_to_all_single(recv, wire, group=g, async_op=True)
        out = Pending(work, recv, send.device)
        return out if async_op else out.wait()

    def all_gather(self, axis: str, x: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
        """The axis's tiles concatenated along ``dim``, in axis order."""
        g = self.groups[axis]
        if g is None:
            return x
        wire = self._to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.shape[axis])]
        dist.all_gather(parts, wire, group=g)
        return torch.cat(parts, dim).to(x.device)

    def all_reduce(self, axis: str, x: torch.Tensor,
                   op: str = "sum") -> torch.Tensor:
        """A new tensor holding the ``op`` (``"sum"`` or ``"max"``) of
        ``x`` over the axis."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        g = self.groups[axis]
        if g is None:
            return x.clone()
        wire = self._to_wire(x)
        if wire.data_ptr() == x.data_ptr():
            wire = wire.clone()
        dist.all_reduce(wire, op=ops[op], group=g)
        return wire.to(x.device)

    def barrier(self) -> None:
        """Return once every rank of the mesh has called it (an all-reduce
        over each axis; the identity without a process group)."""
        for axis in (FEAT_AXIS, NODES_AXIS):
            self.all_reduce(axis, torch.zeros(1, device=self.device))

    def sum_in_order(self, axis: str, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis in rank order, ``((x_0 + x_1) +
        x_2) + ...``, the same bits on every rank and every run,
        whatever order a library's reduction would take."""
        g = self.groups[axis]
        if g is None:
            return x.clone()
        parts = self.all_gather(axis, x[None])
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out


def make_mesh(n_nodes_parts: int | None = None, n_feat_parts: int = 1,
              device=None, transport: str | None = None) -> Mesh | None:
    """Build a ("nodes", "feat") mesh over the first ``n_nodes_parts *
    n_feat_parts`` ranks of the world.

    Every rank of the world calls this, in the same order and with the
    same arguments, since it creates the axes' process groups; a rank
    outside the mesh gets None. ``n_nodes_parts=None`` gives every rank
    to "nodes" after carving out ``n_feat_parts``. ``transport`` defaults
    to the world's backend; ``device`` to :func:`rank_device`'s card
    (``"cpu"`` only when asked). With no process group only (1, 1) is
    possible, and its collectives are the identity.
    """
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_nodes_parts is None:
        if world % n_feat_parts:
            raise ValueError(f"{world} devices not divisible by feat axis "
                             f"{n_feat_parts}")
        n_nodes_parts = world // n_feat_parts
    need = n_nodes_parts * n_feat_parts
    if need > world:
        raise ValueError(f"mesh {n_nodes_parts}x{n_feat_parts} needs {need} "
                         f"devices, have {world}")
    if initialized:
        transport = transport or dist.get_backend()
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; one of "
                             f"{TRANSPORTS}")
    elif transport is not None:
        raise ValueError("a transport needs an initialized process group "
                         "(init_distributed or parallel.distributed.launch)")
    dev = rank_device(device)
    if transport == "nccl":
        if dev.type != "cuda":
            raise ValueError("transport 'nccl' needs CUDA devices")
        cards = torch.cuda.device_count()
        if need > cards:
            raise ValueError(
                f"an NCCL mesh of {need} ranks needs {need} cards, this "
                f"machine has {cards}: NCCL refuses two ranks of one "
                "communicator on one card (use transport='gloo')")
        torch.cuda.set_device(dev)

    groups = {NODES_AXIS: None, FEAT_AXIS: None}
    if initialized:
        # the same new_group calls in the same order on every rank
        for i in range(n_nodes_parts):
            members = [i * n_feat_parts + j for j in range(n_feat_parts)]
            g = dist.new_group(members, backend=transport)
            if rank in members:
                groups[FEAT_AXIS] = g
        for j in range(n_feat_parts):
            members = [i * n_feat_parts + j for i in range(n_nodes_parts)]
            g = dist.new_group(members, backend=transport)
            if rank in members:
                groups[NODES_AXIS] = g
    if rank >= need:
        return None
    return Mesh(shape={NODES_AXIS: n_nodes_parts, FEAT_AXIS: n_feat_parts},
                rank=rank,
                coords={NODES_AXIS: rank // n_feat_parts,
                        FEAT_AXIS: rank % n_feat_parts},
                groups=groups, device=dev, transport=transport)


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Pick a (nodes, feat) factorization for n ranks: a tensor-parallel
    factor of 2 when n is even and at least 4, else all on "nodes"."""
    if n_devices % 2 == 0 and n_devices >= 4:
        return (n_devices // 2, 2)
    return (n_devices, 1)
