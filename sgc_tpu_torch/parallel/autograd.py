"""Gradients through the sharded hops (what JAX derives by transposing
the reference's ``shard_map`` programs: the exchanges of
sgc_tpu/parallel/spmm.py:33-130, halo.py:340-406 and
blockdense.py:484-553).

The kernels are launched through ctypes, so autograd cannot see into a
hop; each hop form is a ``torch.autograd.Function`` whose backward runs
the same kernels over transposed operands and the same collectives in
reverse. On rank r, with ``g`` the gradient of the loss at the hop's
output rows:

* **all-gather** (``y = A_r @ all_gather(x)``): ``A_r^T g`` (kernel B over
  the transpose of the rank's edges, ``[N_pad, F]``), then the
  all-gather's transpose, a reduce-scatter, done as an equal-block
  all_to_all and a sum of the P blocks in rank order.
* **halo** (``y = A_r [x_r ; a2a(pack(x_r))]``): ``A_r^T g`` (kernel B
  over the transposed gather table), split into the local rows and the
  ``[P * H, F]`` received block; the block goes back by the same
  equal-block all_to_all (its own transpose); kernel B over the send
  scatter (``ops.spmm.scatter_graph`` of the live send slots) adds the
  returned rows into the rows they were packed from, a row sent to
  several peers summing in peer order. Padded send slots are referenced
  by no edge, so they carry exact zeros back, and the scatter leaves
  them out.
* **overlapped halo**: the boundary term's transpose first, its rows'
  exchange started, the interior term's transpose while it is in
  flight, then the wait and the scatter.
* **block-dense**: the dense cells' ``C^T g`` on kernel A over a
  transposed cell plan (each 512 x 512 bf16 cell transposed, (rb, st)
  swapped and re-sorted into kernel A's (rb, st) order; built on the
  host once per plan and placed once, so it doubles the rank's cell
  bytes), the remainders' on kernel B over their transposes, and the
  exchange as above. At ``precision="bf16"`` kernel A rounds g to bf16
  as the forward rounds x.

``edge_chunk`` runs each transposed kernel-B term as launches over
consecutive ranges of its sorted edges, as the forward does.

No term uses ``index_add_`` / ``scatter_add_``: every sum is a kernel-B
row or an ordered sum of whole blocks, so a backward gives the same bits
on every run. The kernel wrappers still refuse operands that need a
gradient: each Function hands them detached tensors. Every rank runs
every collective of a backward in the same order (a rank with an empty
part exchanges zeros), or the world would hang.

The transposed operands are built on first use per plan and rank and
cached with the forward views (``parallel/spmm.py::local_view``, kinds
``"allgather_t"``, ``"halo_t"``, ``"blockdense_t"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch.ops.spmm import scatter_graph
from sgc_tpu_torch.ops.spmm_blockdense import (
    BlockDenseArgs,
    BlockDenseSplit,
    blockdense_device_args,
)
from sgc_tpu_torch.parallel import blockdense as _bd
from sgc_tpu_torch.parallel.halo import (
    LocalCsr,
    exchange_and_spmm,
    exchange_and_spmm_overlapped,
    pair_width_matrix,
    segment_spmm,
)
from sgc_tpu_torch.parallel.mesh import NODES_AXIS, Mesh
from sgc_tpu_torch.utils.profiling import within

# kernel launches made by the sharded hops' backwards, sub-counts of
# launch.blockdense_cells and launch.csr_spmm
_BACKWARD = {"launch.blockdense_cells": "within.blockdense_cells_backward",
             "launch.csr_spmm": "within.csr_spmm_backward"}


# ------------------------------------------------------ transposed operands


def transpose_cells(split: BlockDenseSplit, device
                    ) -> tuple[BlockDenseSplit, BlockDenseArgs]:
    """The transposed dense-cell term of ``split`` (real cells only) as a
    split of its own, placed on ``device``: cell k becomes ``cells[k]^T``
    at (rb, st) = (st_k, rb_k), re-sorted by (rb, st) with its own row
    pointers, ``n_rows`` / ``n_cols`` and ``row_block`` / ``stripe``
    swapped. ``apply_cells`` over it computes ``C^T @ g``."""
    k = split.n_cells
    rb, st = split.rb_ids[:k], split.st_ids[:k]
    order = np.lexsort((rb, st))              # by new row block, then stripe
    cells = np.ascontiguousarray(
        np.asarray(split.cells[:k])[order].transpose(0, 2, 1))
    t = BlockDenseSplit(
        cells=cells, rb_ids=st[order].astype(np.int32),
        st_ids=rb[order].astype(np.int32), rest=None,
        n_rows=split.n_cols, n_cols=split.n_rows,
        row_block=split.stripe, stripe=split.row_block, n_cells=k,
        n_slots=k, dense_edges=0, sparse_edges=0, min_edges=0.0)
    return t, blockdense_device_args(t, device)


def live_send_slots(pgraph, halo_width: int, part: int) -> np.ndarray:
    """bool ``[P * H]``: the slots of ``part``'s send buffer that carry a
    row. Block q's slots are filled from 0, one per row q needs from
    ``part`` (``halo.pair_width_matrix``); the rest are padding."""
    need = pair_width_matrix(pgraph)[:, part]
    return (np.arange(halo_width)[None, :] < need[:, None]).reshape(-1)


def send_scatter(send_idx: torch.Tensor, rows_per_part: int,
                 live: np.ndarray) -> LocalCsr:
    """The ``[R, P * H]`` graph adding received slot j's row into row
    ``send_idx[j]`` for the ``live`` slots, each row's slots in
    increasing order: the pack's transpose. Padded slots are left out:
    they send row 0 and get exact zeros back, and would all land on
    row 0, one long row for kernel B."""
    pos = torch.as_tensor(np.flatnonzero(live), device=send_idx.device)
    g = scatter_graph(send_idx.index_select(0, pos), rows_per_part)
    return LocalCsr(dataclasses.replace(
        g, cols=pos.index_select(0, g.cols.long()).to(torch.int32),
        n_cols=int(send_idx.shape[0])))


@dataclasses.dataclass(frozen=True, eq=False)
class LocalTranspose:
    """A rank's backward operands for one plan: the transposes of its
    kernel-B graphs, its cells' transposed splits (None without cells)
    and the send scatter (None for the all-gather form)."""

    edges: LocalCsr | None = None          # all-gather: A_r^T
    table: LocalCsr | None = None          # halo: the gather table's
    interior: LocalCsr | None = None       # overlapped / block-dense rests
    boundary: LocalCsr | None = None
    cells_int: tuple | None = None         # (split, args) of C_int^T
    cells_bnd: tuple | None = None
    scatter: LocalCsr | None = None


def transposed_view(kind: str, local, device,
                    live: np.ndarray | None = None) -> LocalTranspose:
    """Build the backward operands of a forward view (``kind`` one of
    ``"allgather"``, ``"halo"``, ``"blockdense"``; ``live`` the rank's
    live send slots, :func:`live_send_slots`, for the last two)."""
    if kind == "allgather":
        return LocalTranspose(edges=local.transposed())
    scatter = send_scatter(local.send_idx, local.rows_per_part, live)
    if kind == "halo":
        if local.table is not None:
            return LocalTranspose(table=local.table.transposed(),
                                  scatter=scatter)
        return LocalTranspose(interior=local.interior.transposed(),
                              boundary=local.boundary.transposed(),
                              scatter=scatter)
    return LocalTranspose(
        interior=local.rest_int.transposed(),
        boundary=local.rest_bnd.transposed(),
        cells_int=(transpose_cells(local.split_int, device)
                   if local.split_int is not None else None),
        cells_bnd=(transpose_cells(local.split_bnd, device)
                   if local.split_bnd is not None else None),
        scatter=scatter)


def _return_rows(mesh: Mesh, t: LocalTranspose, g_local: torch.Tensor,
                 pending) -> torch.Tensor:
    """Wait for the returned halo gradients and add them into the rows
    they were packed from (kernel B over the send scatter)."""
    g_send = pending.wait().contiguous()
    return segment_spmm(t.scatter, g_send, dense=g_local.contiguous())


def _cells_t(cells, g: torch.Tensor, precision: str):
    """``C^T @ g`` on kernel A, or None without cells."""
    if cells is None:
        return None
    split, args = cells
    return _bd.apply_cells(split, args, g, precision)


# ------------------------------------------------------------- Functions


class AllGatherHopFn(torch.autograd.Function):
    """``A_r @ all_gather(x)`` over the "nodes" axis."""

    @staticmethod
    def forward(ctx, x, mesh, csr, transposed, edge_chunk):
        ctx.mesh, ctx.transposed, ctx.edge_chunk = mesh, transposed, \
            edge_chunk
        ctx.rows = int(x.shape[0])
        x_full = mesh.all_gather(NODES_AXIS, x.detach().contiguous())
        return segment_spmm(csr, x_full, edge_chunk)

    @staticmethod
    def backward(ctx, g):
        mesh, t = ctx.mesh, ctx.transposed()
        with within(_BACKWARD):
            g_full = segment_spmm(t.edges, g.contiguous(), ctx.edge_chunk)
        # the all-gather's transpose: block q goes to rank q, and the P
        # blocks received are summed in rank order
        blocks = mesh.all_to_all(NODES_AXIS, g_full)
        blocks = blocks.view(-1, ctx.rows, g_full.shape[1])
        gx = blocks[0].clone()
        for b in blocks[1:]:
            gx += b
        return gx, None, None, None, None


class HaloHopFn(torch.autograd.Function):
    """One halo-exchanged hop, single exchange or overlapped (by the
    plan): kernel B over ``[x_r ; received rows]``."""

    @staticmethod
    def forward(ctx, x, mesh, local, transposed, edge_chunk):
        ctx.mesh, ctx.transposed, ctx.edge_chunk = mesh, transposed, \
            edge_chunk
        ctx.rows = int(x.shape[0])
        x = x.detach().contiguous()
        if local.table is None:
            return exchange_and_spmm_overlapped(mesh, local, x, edge_chunk)
        return exchange_and_spmm(mesh, local, x, edge_chunk)

    @staticmethod
    def backward(ctx, g):
        mesh, t, ec, R = ctx.mesh, ctx.transposed(), ctx.edge_chunk, ctx.rows
        g = g.contiguous()
        with within(_BACKWARD):
            if t.table is not None:
                g_cat = segment_spmm(t.table, g, ec)
                pending = mesh.all_to_all(NODES_AXIS, g_cat[R:],
                                          async_op=True)
                g_local = g_cat[:R]
            else:
                g_halo = segment_spmm(t.boundary, g, ec)
                pending = mesh.all_to_all(NODES_AXIS, g_halo,
                                          async_op=True)
                # the interior transpose runs while the rows travel
                g_local = segment_spmm(t.interior, g, ec)
            gx = _return_rows(mesh, t, g_local, pending)
        return gx, None, None, None, None


class BlockDenseHopFn(torch.autograd.Function):
    """One block-dense hop (kernels A and B around the exchange)."""

    @staticmethod
    def forward(ctx, x, mesh, local, transposed, precision, form,
                interpret):
        ctx.mesh, ctx.transposed, ctx.precision = mesh, transposed, \
            precision
        return _bd.blockdense_exchange_and_spmm(
            mesh, local, x.detach().contiguous(), precision=precision,
            form=form, interpret=interpret)

    @staticmethod
    def backward(ctx, g):
        mesh, t, prec = ctx.mesh, ctx.transposed(), ctx.precision
        g = g.contiguous()
        with within(_BACKWARD):
            g_halo = segment_spmm(t.boundary, g,
                                  dense=_cells_t(t.cells_bnd, g, prec))
            pending = mesh.all_to_all(NODES_AXIS, g_halo, async_op=True)
            # the interior terms run while the rows travel
            g_local = segment_spmm(t.interior, g,
                                   dense=_cells_t(t.cells_int, g, prec))
            gx = _return_rows(mesh, t, g_local, pending)
        return gx, None, None, None, None, None, None
