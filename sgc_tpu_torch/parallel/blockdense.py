"""Sharded block-dense SpMM: the single-device block-dense formulation on
the mesh (the counterpart of sgc_tpu/parallel/blockdense.py).

Geometry (per part q, as in the reference):

    x_local            [R, F_loc]   rows the part owns (R = rows_per_part)
    halo buffer        [P*H, F_loc] boundary rows received by all_to_all
    gather table       local rows at stripe positions [0, R_up), halo
                       rows at [R_up, R_up + P*H), zero-padded to T_pad;
                       R_up = R rounded up to the stripe width, so local
                       and halo rows never share a stripe.

Each part's edges (local rows, gather-table columns) are split by the
single-device admission (``ops/spmm_blockdense.split_block_dense``'s
per-cell count rule), then cells and remainder are split again by
whether their stripe or column lies in the halo region:

    interior  -- stripes and columns inside [0, R_up): reads x_local
                 only, so it runs while the all_to_all is in flight;
    boundary  -- stripes and columns in the halo region: after the wait.

Host side (:func:`build_sharded_blockdense`): every array equals the
reference's bit for bit, padding included, by both routes (the fast one,
native cell scatter straight into the stacked buffer, and the portable
one, per-part ``split_block_dense`` then restack). Cells are raw bf16
bits in ``uint16``; ``zeros_hugepage`` is ``np.zeros`` here (the
reference's huge-page allocator is not ported). The port adds
``part_cells_int`` / ``part_cells_bnd``, each part's real cell count, so
that a rank runs on an unpadded view of its own part.

Device side, per hop on rank q (:func:`blockdense_exchange_and_spmm`):

    1. pack + all_to_all of the halo rows, started asynchronously
    2. kernel A (``apply_cells``, cells in (rb, st) order) over the
       interior cells, then kernel B over the interior remainder adding
       that term in its epilogue
    3. wait; kernel A over the boundary cells (added), then kernel B
       over the boundary remainder adding the running sum

On a CPU tensor kernel A's wrapper runs ``apply_cells_plain`` and kernel
B's ``spmm_segment_plain``. The reference's shard_map glue
(``blockdense_flat_args``, ``blockdense_in_specs``) has no counterpart:
a rank reads its own part directly (:func:`local_blockdense`).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import numpy as np
import torch

from sgc_tpu_torch import native
from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops.spmm import check_precision
from sgc_tpu_torch.ops.spmm_blockdense import (
    DEFAULT_BYTE_BUDGET,
    DEFAULT_ROW_BLOCK,
    DEFAULT_STRIPE,
    BlockDenseArgs,
    BlockDenseSplit,
    _scan_chunk,
    apply_cells,
    blockdense_device_args,
    min_edges_for,
    split_block_dense,
)
from sgc_tpu_torch.parallel.halo import (
    HaloDescriptor,
    LocalCsr,
    local_csr,
    pack,
    segment_spmm,
)
from sgc_tpu_torch.parallel.mesh import NODES_AXIS, Mesh
from sgc_tpu_torch.parallel.partition import (
    PartitionedGraph,
    _round_up,
    place,
)

REST_PAD = 8
FORMS = ("scan", "pallas")


@dataclasses.dataclass(frozen=True)
class ShardedBlockDense:
    """Per-part block-dense splits in gather-table coordinates, stacked
    along a leading [P] axis.

    cells_*: uint16 bf16 bits [P, C, RB, W]; rb_*/st_*: int32[P, C];
    interior stripe ids index the local stripe space [0, R_up/W),
    boundary ones are rebased to the halo stripe space [0,
    (T_pad - R_up)/W). Pad slots are zero cells repeating the part's last
    (rb, st), or (0, 0) for a part with none. vis_*: bool[P, n_rb], the
    row blocks a part's cells (or its (0, 0) pad) write. rest_*: (rows,
    cols, vals) [P, E]; interior cols index x_local, boundary cols the
    halo buffer; padding edges are (R-1, 0, 0). send_idx: the
    HaloDescriptor's. part_cells_*: int64[P], each part's real cells
    (the port's addition).
    """

    cells_int: np.ndarray
    rb_int: np.ndarray
    st_int: np.ndarray
    vis_int: np.ndarray
    cells_bnd: np.ndarray
    rb_bnd: np.ndarray
    st_bnd: np.ndarray
    vis_bnd: np.ndarray
    rest_int: tuple
    rest_bnd: tuple
    send_idx: np.ndarray
    row_block: int
    stripe: int
    n_parts: int
    rows_per_part: int
    halo_width: int
    r_up: int
    t_pad: int
    chunk_int: int
    chunk_bnd: int
    n_cells: int
    dense_edges: int
    sparse_edges: int
    part_cells_int: np.ndarray
    part_cells_bnd: np.ndarray

    @property
    def n_rb(self) -> int:
        return -(-self.rows_per_part // self.row_block)

    @property
    def dense_fraction(self) -> float:
        total = self.dense_edges + self.sparse_edges
        return self.dense_edges / max(1, total)


def _pad_cells(per_part: list, n_rb: int):
    """Stack per-part (cells, rb, st) lists to one width: zero pad cells
    repeat the part's last (rb, st) (an empty part gets (0, 0)); also the
    per-part visited row-block mask and the scan chunk."""
    c_max = max((c.shape[0] for c, _, _ in per_part), default=0)
    c_max = max(c_max, 1)
    chunk = _scan_chunk(c_max)
    width = _round_up(c_max, chunk)
    P = len(per_part)
    rb0, w0 = per_part[0][0].shape[1], per_part[0][0].shape[2]
    cells = np.zeros((P, width, rb0, w0), np.uint16)
    rb = np.zeros((P, width), np.int32)
    st = np.zeros((P, width), np.int32)
    vis = np.zeros((P, n_rb), np.bool_)
    for p, (c, r, s) in enumerate(per_part):
        k = c.shape[0]
        if k:
            cells[p, :k] = c
            rb[p, :k] = r
            st[p, :k] = s
            rb[p, k:] = r[-1]
            st[p, k:] = s[-1]
            vis[p, np.unique(r)] = True
        else:
            vis[p, 0] = True   # the (0, 0) zero pad cell writes block 0
    return cells, rb, st, vis, chunk


def _pad_rest(per_part: list, rows_per_part: int):
    """Stack per-part (rows, cols, vals) remainders, padded with no-op
    edges (row R-1, col 0, val 0)."""
    e_max = _round_up(max((len(r) for r, _, _ in per_part), default=0),
                      REST_PAD)
    P = len(per_part)
    rows = np.full((P, e_max), rows_per_part - 1, np.int32)
    cols = np.zeros((P, e_max), np.int32)
    vals = np.zeros((P, e_max), np.float32)
    for p, (r, c, v) in enumerate(per_part):
        k = len(r)
        rows[p, :k] = r
        cols[p, :k] = c
        vals[p, :k] = v
    return rows, cols, vals


def build_sharded_blockdense(
    pgraph: PartitionedGraph,
    halo: HaloDescriptor,
    n_features: int,
    row_block: int = DEFAULT_ROW_BLOCK,
    stripe: int = DEFAULT_STRIPE,
    min_edges: float | None = None,
    byte_budget: int = DEFAULT_BYTE_BUDGET,
    device=True,
) -> ShardedBlockDense:
    """Host-side plan: per-part block-dense split of the halo-remapped
    edge lists, interior and boundary apart (module docstring).

    ``n_features`` is the per-rank feature width (F / feat-axis size),
    which the admission rule compares against. ``byte_budget`` caps each
    part's bf16 cell bytes. ``device`` as in ``partition_graph`` (False
    keeps every array host numpy, as the ranks read it).

    This is the fast route (native cell scatter straight into the stacked
    buffers, a thread per part); :func:`_build_sharded_portable` is the
    per-part composition the tests hold it against, bit for bit.
    """
    return _build_sharded_fast(pgraph, halo, n_features, row_block, stripe,
                               min_edges, byte_budget, device)


def _geometry(pgraph, halo, stripe):
    R, H, P = pgraph.rows_per_part, halo.halo_width, pgraph.n_parts
    r_up = _round_up(R, stripe)
    return R, H, P, r_up, r_up + _round_up(P * H, stripe)


def _place_plan(device, ci, rbi, sti, vis_i, cb, rbb, stb, vis_b, ri, rb_,
                halo, **meta) -> ShardedBlockDense:
    return ShardedBlockDense(
        cells_int=place(ci, device), rb_int=place(rbi, device),
        st_int=place(sti, device), vis_int=place(vis_i, device),
        cells_bnd=place(cb, device), rb_bnd=place(rbb, device),
        st_bnd=place(stb, device), vis_bnd=place(vis_b, device),
        rest_int=tuple(place(a, device) for a in ri),
        rest_bnd=tuple(place(a, device) for a in rb_),
        send_idx=halo.send_idx, **meta)


def _build_sharded_fast(pgraph, halo, n_features, row_block, stripe,
                        min_edges, byte_budget, device) -> ShardedBlockDense:
    """Direct-scatter plan build (see :func:`build_sharded_blockdense`)."""
    R, H, P, r_up, t_pad = _geometry(pgraph, halo, stripe)
    n_st_loc = r_up // stripe
    n_st = t_pad // stripe
    n_rb = -(-R // row_block)
    if min_edges is None:
        min_edges = min_edges_for(row_block, stripe, n_features)
    max_cells = max(int(byte_budget // (2 * row_block * stripe)), 0)

    cols_halo = host(halo.cols_halo)
    rows_l = host(pgraph.rows_local)
    vals_all = host(pgraph.vals)
    pow2 = (row_block & (row_block - 1) == 0
            and stripe & (stripe - 1) == 0)

    def phase1(p):
        # this part's live edges in gather-table coordinates, sorted, and
        # the per-cell admission decision
        live = vals_all[p] != 0
        r = rows_l[p][live].astype(np.int64)
        ch = cols_halo[p][live].astype(np.int64)
        v = vals_all[p][live].astype(np.float32)
        ct = np.where(ch < R, ch, ch - R + r_up)
        native.sort_edges_inplace(r, ct, v, R, t_pad)
        if pow2:
            cell = ((r >> row_block.bit_length() - 1) * n_st
                    + (ct >> stripe.bit_length() - 1))
        else:
            cell = (r // row_block) * n_st + (ct // stripe)
        counts = np.bincount(cell, minlength=n_rb * n_st)
        qualifying = np.flatnonzero(counts > min_edges)
        if len(qualifying) > max_cells:
            order = np.argsort(-counts[qualifying], kind="stable")
            qualifying = np.sort(qualifying[order[:max_cells]])
        st_q = qualifying % n_st
        return (r, ct, v, qualifying[st_q < n_st_loc],
                qualifying[st_q >= n_st_loc],
                int(counts[qualifying].sum()))

    workers = min(P, os.cpu_count() or 1)
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(phase1, range(P)))

    def alloc_cells(c_max):
        c_max = max(c_max, 1)
        chunk = _scan_chunk(c_max)
        width = _round_up(c_max, chunk)
        flat = np.zeros(P * width * row_block * stripe, np.uint16)
        return flat.reshape(P, width, row_block, stripe), flat, width, chunk

    ci, ci_flat, w_int, chunk_i = alloc_cells(
        max(len(q) for _, _, _, q, _, _ in parts))
    cb, cb_flat, w_bnd, chunk_b = alloc_cells(
        max(len(q) for _, _, _, _, q, _ in parts))
    rbi = np.zeros((P, w_int), np.int32)
    sti = np.zeros((P, w_int), np.int32)
    vis_i = np.zeros((P, n_rb), np.bool_)
    rbb = np.zeros((P, w_bnd), np.int32)
    stb = np.zeros((P, w_bnd), np.int32)
    vis_b = np.zeros((P, n_rb), np.bool_)
    rest_int, rest_bnd = [None] * P, [None] * P

    def ids_fill(q, rb_arr, st_arr, vis, p, st_base):
        k = len(q)
        if not k:
            vis[p, 0] = True  # the (0, 0) zero pad cell writes block 0
            return
        rb_loc = (q // n_st).astype(np.int32)
        rb_arr[p, :k] = rb_loc
        st_arr[p, :k] = (q % n_st - st_base).astype(np.int32)
        rb_arr[p, k:] = rb_loc[-1]         # pads repeat the last (rb, st)
        st_arr[p, k:] = st_arr[p, k - 1]   # so rb stays non-decreasing
        vis[p, np.unique(rb_loc)] = True

    def phase2(p):
        r, ct, v, q_int, q_bnd, _ = parts[p]
        mask_int = np.zeros(len(r), np.uint8)
        mask_bnd = np.zeros(len(r), np.uint8)
        compact = np.full(n_rb * n_st, -1, np.int64)
        if len(q_int):
            compact[q_int] = p * w_int + np.arange(len(q_int))
            native.cell_scatter(r, ct, v, compact, n_st, row_block,
                                stripe, ci_flat, mask_int)
            compact[q_int] = -1
        if len(q_bnd):
            compact[q_bnd] = p * w_bnd + np.arange(len(q_bnd))
            native.cell_scatter(r, ct, v, compact, n_st, row_block,
                                stripe, cb_flat, mask_bnd)
        restm = (mask_int | mask_bnd) == 0
        rr, rc, rv = r[restm], ct[restm], v[restm]
        m_loc = rc < R
        rest_int[p] = (rr[m_loc], rc[m_loc], rv[m_loc])
        rest_bnd[p] = (rr[~m_loc], rc[~m_loc] - r_up, rv[~m_loc])
        ids_fill(q_int, rbi, sti, vis_i, p, 0)
        ids_fill(q_bnd, rbb, stb, vis_b, p, n_st_loc)

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(phase2, range(P)))
    dense_edges = sum(d for *_, d in parts)
    sparse_edges = sum(len(r) for r, *_ in parts) - dense_edges
    return _place_plan(
        device, ci, rbi, sti, vis_i, cb, rbb, stb, vis_b,
        _pad_rest(rest_int, R), _pad_rest(rest_bnd, R), halo,
        row_block=row_block, stripe=stripe, n_parts=P, rows_per_part=R,
        halo_width=H, r_up=r_up, t_pad=t_pad, chunk_int=chunk_i,
        chunk_bnd=chunk_b,
        n_cells=sum(len(q[3]) + len(q[4]) for q in parts),
        dense_edges=dense_edges, sparse_edges=sparse_edges,
        part_cells_int=np.array([len(q[3]) for q in parts], np.int64),
        part_cells_bnd=np.array([len(q[4]) for q in parts], np.int64))


def _build_sharded_portable(pgraph, halo, n_features, row_block, stripe,
                            min_edges, byte_budget,
                            device) -> ShardedBlockDense:
    """Composition-of-parts plan build: per-part ``split_block_dense``,
    then restack (the reference's behavioural reference for the fast
    route)."""
    R, H, P, r_up, t_pad = _geometry(pgraph, halo, stripe)
    n_st_loc = r_up // stripe

    cols_halo = host(halo.cols_halo)
    rows_l = host(pgraph.rows_local)
    vals = host(pgraph.vals)

    per_int, per_bnd = [], []
    rest_int, rest_bnd = [], []
    n_cells = dense_edges = sparse_edges = 0
    for p in range(P):
        live = vals[p] != 0
        r = rows_l[p][live].astype(np.int64)
        ch = cols_halo[p][live].astype(np.int64)
        v = vals[p][live]
        # halo positions (>= R) shift up so local stripes never mix with
        # halo rows; gap rows [R, r_up) stay empty
        ct = np.where(ch < R, ch, ch - R + r_up)
        g = SparseGraph.from_coo(r, ct, v, n_rows=R, n_cols=t_pad)
        split = split_block_dense(
            g, n_features, row_block, stripe,
            min_edges=min_edges, byte_budget=byte_budget)
        n_cells += split.n_cells
        dense_edges += split.dense_edges
        sparse_edges += split.sparse_edges

        k = split.n_cells
        c, rb, st = split.cells[:k], split.rb_ids[:k], split.st_ids[:k]
        is_int = st < n_st_loc
        per_int.append((c[is_int], rb[is_int], st[is_int]))
        per_bnd.append((c[~is_int], rb[~is_int],
                        (st[~is_int] - n_st_loc).astype(np.int32)))

        if split.rest is not None:
            rr = host(split.rest.rows)[: split.rest.nnz]
            rc = host(split.rest.cols)[: split.rest.nnz]
            rv = host(split.rest.vals)[: split.rest.nnz]
            m = rc < R
            rest_int.append((rr[m], rc[m], rv[m]))
            rest_bnd.append((rr[~m], (rc[~m] - r_up).astype(np.int64),
                             rv[~m]))
        else:
            empty = (np.zeros(0, np.int64),) * 3
            rest_int.append(empty)
            rest_bnd.append(empty)

    n_rb = -(-R // row_block)
    ci, rbi, sti, vis_i, chunk_i = _pad_cells(per_int, n_rb)
    cb, rbb, stb, vis_b, chunk_b = _pad_cells(per_bnd, n_rb)
    return _place_plan(
        device, ci, rbi, sti, vis_i, cb, rbb, stb, vis_b,
        _pad_rest(rest_int, R), _pad_rest(rest_bnd, R), halo,
        row_block=row_block, stripe=stripe, n_parts=P, rows_per_part=R,
        halo_width=H, r_up=r_up, t_pad=t_pad, chunk_int=chunk_i,
        chunk_bnd=chunk_b, n_cells=n_cells, dense_edges=dense_edges,
        sparse_edges=sparse_edges,
        part_cells_int=np.array([len(c) for c, _, _ in per_int], np.int64),
        part_cells_bnd=np.array([len(c) for c, _, _ in per_bnd], np.int64))


# ------------------------------------------------------------ device side


@dataclasses.dataclass(frozen=True, eq=False)
class LocalBlockDense:
    """Rank q's device view of a sharded plan, built once per plan: its
    ``send_idx`` row (int64 ``[P * H]``), its interior and boundary cells
    as single-device splits (``n_cols`` R and P * H, the real cells only,
    kernel A's ``rb_ptr`` / ``cell_of`` index placed; None for a part
    with no cells) and its remainders as kernel-B graphs."""

    send_idx: torch.Tensor
    rows_per_part: int
    split_int: BlockDenseSplit | None
    args_int: BlockDenseArgs | None
    split_bnd: BlockDenseSplit | None
    args_bnd: BlockDenseArgs | None
    rest_int: LocalCsr
    rest_bnd: LocalCsr


def _part_split(bd: ShardedBlockDense, cells, rb, st, k: int, n_cols: int,
                device):
    if k == 0:
        return None, None
    # copies: the plan's arrays may be read-only memory maps
    split = BlockDenseSplit(
        cells=np.array(host(cells[:k])), rb_ids=np.array(host(rb[:k])),
        st_ids=np.array(host(st[:k])), rest=None,
        n_rows=bd.rows_per_part, n_cols=n_cols, row_block=bd.row_block,
        stripe=bd.stripe, n_cells=k, n_slots=k, dense_edges=0,
        sparse_edges=0, min_edges=0.0)
    return split, blockdense_device_args(split, device)


def local_blockdense(mesh: Mesh, bd: ShardedBlockDense) -> LocalBlockDense:
    """Place rank ``mesh``'s part of ``bd`` on its device (reads only that
    part of memory-mapped host arrays)."""
    p, dev = mesh.coords[NODES_AXIS], mesh.device
    R, PH = bd.rows_per_part, bd.n_parts * bd.halo_width
    split_int, args_int = _part_split(
        bd, bd.cells_int[p], bd.rb_int[p], bd.st_int[p],
        int(bd.part_cells_int[p]), R, dev)
    split_bnd, args_bnd = _part_split(
        bd, bd.cells_bnd[p], bd.rb_bnd[p], bd.st_bnd[p],
        int(bd.part_cells_bnd[p]), PH, dev)
    ri, rc, rv = (host(a[p]) for a in bd.rest_int)
    bi, bc, bv = (host(a[p]) for a in bd.rest_bnd)
    return LocalBlockDense(
        send_idx=torch.as_tensor(host(bd.send_idx[p]).reshape(-1).astype(
            np.int64), device=dev),
        rows_per_part=R, split_int=split_int, args_int=args_int,
        split_bnd=split_bnd, args_bnd=args_bnd,
        rest_int=local_csr(ri, rc, rv, R, R, dev),
        rest_bnd=local_csr(bi, bc, bv, R, PH, dev))


def check_form(form: str, interpret: bool, x: torch.Tensor) -> None:
    """The reference's ``form`` and ``interpret`` arguments: both forms
    run kernel A on a CUDA tensor (``apply_cells_plain`` on a CPU
    tensor); ``interpret=True`` (the reference's Pallas interpreter)
    raises on a CUDA tensor."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    if interpret and x.device.type == "cuda":
        raise ValueError("interpret=True runs the reference's Pallas "
                         "interpreter; on a CUDA tensor the cell term is "
                         "kernel A")


def blockdense_exchange_and_spmm(mesh: Mesh, local: LocalBlockDense,
                                 x_local: torch.Tensor,
                                 precision: str = "bf16",
                                 form: str = "scan",
                                 interpret: bool = False) -> torch.Tensor:
    """One halo-exchanged block-dense hop on this rank: the interior
    terms (kernel A, then kernel B adding it) run while the all_to_all is
    in flight; after the wait the boundary cells (kernel A) and the
    boundary remainder (kernel B) add in. ``form`` and ``interpret`` as
    :func:`check_form` says."""
    check_precision(precision)
    check_form(form, interpret, x_local)
    x_local = x_local.contiguous()
    pending = mesh.all_to_all(NODES_AXIS, pack(x_local, local.send_idx),
                              async_op=True)
    dense = (apply_cells(local.split_int, local.args_int, x_local, precision)
             if local.split_int is not None else None)
    acc = segment_spmm(local.rest_int, x_local, dense=dense)
    halo = pending.wait()
    if local.split_bnd is not None:
        acc = acc + apply_cells(local.split_bnd, local.args_bnd, halo,
                                precision)
    return segment_spmm(local.rest_bnd, halo, dense=acc)
