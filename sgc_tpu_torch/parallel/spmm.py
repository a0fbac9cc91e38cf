"""Sharded SpMM: K-hop propagation over a ("nodes", "feat") mesh (the
counterpart of sgc_tpu/parallel/spmm.py).

Every rank holds its row block of S and its ``[R, F / n_feat]`` tile of
x, and calls these functions with that tile. Per hop:

  * all-gather: the "nodes" axis all-gathers x, then kernel B runs over
    the rank's edges (global columns);
  * halo: one all_to_all of the boundary rows, then kernel B over the
    gather table (``parallel/halo.py``); the overlapped halo plan runs
    the interior term while the exchange is in flight;
  * block-dense: kernels A and B around the same exchange
    (``parallel/blockdense.py``).

SpMM is independent across feature columns, so the "feat" axis shards
x's columns with no communication. Padding edges add nothing, so padded
rows stay 0 over repeated hops.

Each rank's device view of a plan (row-sorted CSR graphs, cells, the
send index) is built on first use and cached per (plan, rank, device),
never per hop; :func:`clear_local` frees the cached views.
"""

from __future__ import annotations

import torch

from sgc_tpu_torch.parallel.blockdense import (
    blockdense_exchange_and_spmm,
    local_blockdense,
)
from sgc_tpu_torch.parallel.distributed import NODE_FEAT, put_global
from sgc_tpu_torch.parallel.halo import (
    exchange_and_spmm,
    exchange_and_spmm_overlapped,
    local_csr,
    local_halo,
    segment_spmm,
)
from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, Mesh
from sgc_tpu_torch.parallel.partition import PartitionedGraph
from sgc_tpu_torch.utils.buildcache import HostBuildCache
from sgc_tpu_torch.utils.profiling import sync

# each rank's placed views; the host plans they came from are pinned
# inside the entries so an id() is never reused while cached
_LOCAL = HostBuildCache(8)


def local_view(kind: str, mesh: Mesh, pgraph: PartitionedGraph,
               plan=None):
    """The rank's device view of one formulation, placed on first use:
    ``"allgather"`` (a LocalCsr of the part's edges over global
    columns), ``"halo"`` (a LocalHalo of ``plan``) or ``"blockdense"`` (a
    LocalBlockDense of ``plan``)."""
    def build():
        p = mesh.coords[NODES_AXIS]
        if kind == "allgather":
            return local_csr(pgraph.rows_local[p], pgraph.cols[p],
                             pgraph.vals[p], pgraph.rows_per_part,
                             pgraph.n_rows_padded, mesh.device)
        if kind == "halo":
            return local_halo(mesh, pgraph, plan)
        return local_blockdense(mesh, plan)

    pins = (pgraph.rows_local,) + ((plan,) if plan is not None else ())
    return _LOCAL.get(pins, (kind, mesh.coords[NODES_AXIS],
                             str(mesh.device)), build)


def clear_local() -> None:
    """Drop every cached device view (and the device memory it holds)."""
    _LOCAL.clear()


def _local_spmm(mesh: Mesh, pgraph: PartitionedGraph,
                x_full: torch.Tensor, edge_chunk: int | None = None):
    """Kernel B over the rank's edges against the gathered features;
    ``edge_chunk`` as ``halo.segment_spmm``."""
    return segment_spmm(local_view("allgather", mesh, pgraph), x_full,
                        edge_chunk)


def spmm_sharded(
    mesh: Mesh, pgraph: PartitionedGraph, x: torch.Tensor, halo=None,
    blockdense=None, precision: str = "bf16", form: str = "scan",
    interpret: bool = False, edge_chunk: int | None = None,
) -> torch.Tensor:
    """One sharded SpMM hop: this rank's tile of S @ x.

    Args:
      mesh:   this rank's ("nodes", "feat") Mesh.
      pgraph: row-block partitioned S (host arrays; every rank holds the
              plan and reads its own part); n_parts must equal the
              "nodes" axis.
      x:      this rank's float32 tile ``[rows_per_part, F / n_feat]``.
      halo:   optional HaloDescriptor: exchange only boundary rows with
              one all_to_all instead of the all-gather.
      blockdense: optional ShardedBlockDense: the hop through kernels A
              and B (supersedes ``halo``; the plan carries its own
              exchange). ``precision`` applies to it only; ``form`` and
              ``interpret`` as ``blockdense.check_form`` says.
      edge_chunk: the segment formulations in launches of that many
              sorted edges each.
    """
    if pgraph.n_parts != mesh.shape[NODES_AXIS]:
        raise ValueError(
            f"graph has {pgraph.n_parts} parts, mesh nodes axis is "
            f"{mesh.shape[NODES_AXIS]}")
    x = x.contiguous()
    if blockdense is not None:
        if edge_chunk:
            raise ValueError(
                "edge_chunk applies to the segment formulations; the "
                "block-dense formulation's dense term is already "
                "tile-bounded and its remainder is not chunked — use "
                "formulation='segment' for memory-bounded hops")
        return blockdense_exchange_and_spmm(
            mesh, local_view("blockdense", mesh, pgraph, blockdense), x,
            precision=precision, form=form, interpret=interpret)
    if halo is not None and halo.overlapped:
        return exchange_and_spmm_overlapped(
            mesh, local_view("halo", mesh, pgraph, halo), x, edge_chunk)
    if halo is not None:
        return exchange_and_spmm(
            mesh, local_view("halo", mesh, pgraph, halo), x, edge_chunk)
    x_full = mesh.all_gather(NODES_AXIS, x)
    return _local_spmm(mesh, pgraph, x_full, edge_chunk)


def _spmm_col_paneled(mesh: Mesh, pgraph: PartitionedGraph, xbox: list,
                      col_chunk: int, **kw) -> torch.Tensor:
    """One sharded hop in feature-column panels of width ``col_chunk``.

    SpMM is columnwise independent, so each panel equals the same
    columns of the unpaneled hop bit for bit. ``xbox`` is a one-element
    list, emptied on entry, and the input is dropped before the panels
    are joined, so at most two full-width arrays are alive at once.
    Needs an unsharded "feat" axis.
    """
    if mesh.shape[FEAT_AXIS] != 1:
        raise ValueError(
            "col_chunk needs an unsharded 'feat' axis (panels would cut "
            "across the feature sharding); use a ('nodes', 1) mesh")
    x = xbox.pop()
    f = int(x.shape[1])
    panels = []
    for c0 in range(0, f, col_chunk):
        w = min(col_chunk, f - c0)
        panel = spmm_sharded(mesh, pgraph, x[:, c0:c0 + w].contiguous(),
                             **kw)
        # one panel at a time: queued panels would stack their transients
        sync(panel.device)
        panels.append(panel)
    del x                      # input dead before the output assembles
    out = torch.cat(panels, dim=1)
    sync(out.device)
    return out


def propagate_sharded(
    mesh: Mesh, pgraph: PartitionedGraph, x, degree: int, halo=None,
    blockdense=None, precision: str = "bf16", form: str = "scan",
    interpret: bool = False, edge_chunk: int | None = None,
    sync_each_hop: bool = False, col_chunk: int | None = None,
) -> torch.Tensor:
    """K sharded SpMM hops (x <- S @ x) on this rank's tile.

    ``sync_each_hop`` waits for each hop before the next is queued (the
    reference's peak-memory control). ``edge_chunk`` bounds each launch's
    edges; ``col_chunk`` runs each hop in feature-column panels
    (:func:`_spmm_col_paneled`; segment formulations only, bit-identical
    output).

    ``x`` may be passed as a one-element list ``[x]`` to hand over
    ownership: the list is emptied at once, so no caller frame keeps the
    hop-0 input alive through the later hops.
    """
    if isinstance(x, list):
        if len(x) != 1:
            raise ValueError("consume form takes a one-element list [x]")
        x = x.pop()              # the caller's list no longer holds it
    if col_chunk is not None:
        if blockdense is not None:
            raise ValueError(
                "col_chunk applies to the segment formulations (the "
                "blockdense plan is built for a fixed feature width)")
        if torch.jit.is_tracing() or torch.compiler.is_compiling():
            raise ValueError(
                "col_chunk panels are host-scheduled — call eagerly, "
                "not under jit")
    for _ in range(degree):
        if col_chunk is not None and int(x.shape[1]) > col_chunk:
            box = [x]
            x = None
            x = _spmm_col_paneled(
                mesh, pgraph, box, col_chunk, halo=halo,
                precision=precision, form=form, interpret=interpret,
                edge_chunk=edge_chunk)
        else:
            x = spmm_sharded(mesh, pgraph, x, halo=halo,
                             blockdense=blockdense, precision=precision,
                             form=form, interpret=interpret,
                             edge_chunk=edge_chunk)
        if sync_each_hop:
            sync(x.device)
    return x


def shard_features(mesh: Mesh, x) -> torch.Tensor:
    """This rank's tile of a full ``[N_pad, F]`` feature matrix, rows
    over "nodes" and columns over "feat" (every rank passes the same
    full host value; see ``parallel/distributed.put_global``)."""
    return put_global(mesh, NODE_FEAT, x)
