"""Halo exchange: boundary-feature all_to_all for partitioned SpMM (the
counterpart of sgc_tpu/parallel/halo.py).

The all-gather exchange moves the whole N x F/pf feature matrix to every
rank each hop. Each row block references only some remote columns (its
"halo"); exchanging exactly those rows with one all_to_all is the
bandwidth-optimal pattern.

Host side, once per graph (bit for bit the reference's):
  * for every (src q -> dst p) pair, the sorted unique columns of p's
    edges that q owns become q's send list to p,
  * all pair lists are padded to one halo width H (all_to_all takes
    equal blocks),
  * edge columns are remapped into gather-table coordinates (rows
    ``[0, R)`` local, ``R + q * H + slot`` from q), so the receiving side
    reads a plain table.

Device side, per hop on rank p:
  1. pack:     send[q] = x_local[send_idx[p, q]]     (index_select)
  2. exchange: all_to_all over the "nodes" axis        (the mesh's)
  3. compute:  kernel B (``ops/spmm.py::spmm_segment``) over the rank's
               edges, row-sorted once per plan into a CSR graph
               (:class:`LocalCsr`); ``edge_chunk`` runs it as one launch
               per range of consecutive sorted edges, each adding into
               the running sum in chunk order (no atomics).

The overlapped form starts the all_to_all with ``async_op=True``, issues
the interior term (edges whose column is local) before it waits, then
the boundary term on the received rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch import native
from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops.spmm import spmm_segment
from sgc_tpu_torch.parallel.mesh import NODES_AXIS, Mesh
from sgc_tpu_torch.parallel.partition import (
    PartitionedGraph,
    _round_up,
    place,
)

HALO_PAD = 8


@dataclasses.dataclass(frozen=True)
class HaloDescriptor:
    """Static exchange plan for one partitioned graph.

    send_idx:  int32[P, P, H]: send_idx[q, p] = local row ids part q
               sends to part p (padded with 0; padded slots are never
               referenced by an edge).
    cols_halo: int32[P, E_max]: edge columns remapped to gather-table
               positions (``R + src_part * H + slot`` for remote ones).
    edges_int / edges_bnd: from ``build_halo(overlap=True)``, the
               (rows, cols, vals) triples ``[P, E]`` of each part's
               INTERIOR edges (cols index x_local) and BOUNDARY edges
               (cols index the halo buffer), padded with (R-1, 0, 0).
    """

    send_idx: np.ndarray | torch.Tensor
    cols_halo: np.ndarray | torch.Tensor
    halo_width: int
    n_parts: int
    edges_int: tuple | None = None
    edges_bnd: tuple | None = None

    @property
    def overlapped(self) -> bool:
        return self.edges_int is not None


def build_halo(pgraph: PartitionedGraph, overlap: bool = False,
               device=True) -> HaloDescriptor:
    """Compute the exchange plan from a partitioned graph (host side).

    Locally owned columns never enter the exchange. H is the largest
    count of unique remote columns over (dst, src) pairs, rounded up to
    ``HALO_PAD``. One sort of (dst_part, src_part, col) keys gives the
    dedup flags, the per-pair slots and the edge remap. ``device`` as in
    :func:`partition_graph`; with ``overlap`` ``cols_halo`` stays host
    numpy, as in the reference (the overlapped hop does not read it).
    """
    P = pgraph.n_parts
    R = pgraph.rows_per_part
    cols = host(pgraph.cols)
    vals = host(pgraph.vals)
    e_max = cols.shape[1]

    real = (vals != 0).ravel()
    flat_cols = cols.ravel().astype(np.int64)
    dst = np.repeat(np.arange(P, dtype=np.int64), e_max)
    src = np.minimum(flat_cols // R, P - 1)

    remote = real & (src != dst)
    r_dst, r_src, r_col = dst[remote], src[remote], flat_cols[remote]
    n_rem = len(r_col)

    ncp = np.int64(P) * R                   # padded column space
    pair = r_dst * P + r_src                # [0, P^2)
    key = pair * ncp + r_col
    order = np.argsort(key, kind="stable")
    ks = key[order]

    is_new = np.empty(n_rem, dtype=bool)
    is_new_pair = np.empty(n_rem, dtype=bool)
    if n_rem:
        is_new[0] = True
        np.not_equal(ks[1:], ks[:-1], out=is_new[1:])
        pair_s = ks // ncp
        is_new_pair[0] = True
        np.not_equal(pair_s[1:], pair_s[:-1], out=is_new_pair[1:])
    else:
        pair_s = ks

    # unique id per sorted element; the pair's first uid carried forward
    uid = np.cumsum(is_new) - 1
    group_uid0 = np.maximum.accumulate(np.where(is_new_pair, uid, -1))
    slot_s = uid - group_uid0               # halo slot per sorted element

    h_max = int(slot_s.max()) + 1 if n_rem else 1
    H = _round_up(max(h_max, 1), HALO_PAD)

    # send_idx[q, p, slot] = local row id on q
    send_idx = np.zeros(P * P * H, dtype=np.int32)
    u_pair = pair_s[is_new]
    u_col = ks[is_new] % ncp
    u_src = u_pair % P
    u_dst = u_pair // P
    send_flat = u_src * (P * H) + u_dst * H + slot_s[is_new]
    send_idx[send_flat] = (u_col - u_src * R).astype(np.int32)
    send_idx = send_idx.reshape(P, P, H)

    # every edge column in its part's gather table: [0, R) = x_local,
    # [R + q*H, R + (q+1)*H) = the halo rows from q
    mapped = np.zeros(P * e_max, dtype=np.int32)
    local = real & (src == dst)
    mapped[local] = (flat_cols[local] - dst[local] * R).astype(np.int32)
    remote_map = np.empty(n_rem, dtype=np.int32)
    remote_map[order] = (R + (pair_s % P) * H + slot_s).astype(np.int32)
    mapped[remote] = remote_map
    cols_halo = mapped.reshape(P, e_max)

    edges_int = edges_bnd = None
    if overlap:
        edges_int, edges_bnd = _split_interior_boundary(
            pgraph, cols_halo, R, device=device)

    return HaloDescriptor(
        send_idx=place(send_idx, device),
        cols_halo=cols_halo if overlap else place(cols_halo, device),
        halo_width=H,
        n_parts=P,
        edges_int=edges_int,
        edges_bnd=edges_bnd,
    )


def _split_interior_boundary(pgraph: PartitionedGraph,
                             cols_halo: np.ndarray, R: int, device=True):
    """Split each part's edges into interior (column < R: reads x_local)
    and boundary (column >= R: reads the halo buffer, re-based to 0),
    each padded per part to one width (a multiple of HALO_PAD) with
    no-op edges (row R-1, col 0, val 0). Relative edge order is kept."""
    P = pgraph.n_parts
    rows = host(pgraph.rows_local)
    vals = host(pgraph.vals)
    is_int = cols_halo < R

    n_int = is_int.sum(axis=1)
    ei = _round_up(max(int(n_int.max()), 1), HALO_PAD)
    eb = _round_up(max(int((cols_halo.shape[1] - n_int).max()), 1),
                   HALO_PAD)

    def _alloc(width):
        return (np.full((P, width), R - 1, np.int32),
                np.zeros((P, width), np.int32),
                np.zeros((P, width), np.float32))

    ri, ci, vi = _alloc(ei)
    rb, cb, vb = _alloc(eb)
    for p in range(P):
        m = is_int[p]
        k = int(m.sum())
        ri[p, :k] = rows[p][m]
        ci[p, :k] = cols_halo[p][m]
        vi[p, :k] = vals[p][m]
        kb = cols_halo.shape[1] - k
        rb[p, :kb] = rows[p][~m]
        cb[p, :kb] = cols_halo[p][~m] - R
        vb[p, :kb] = vals[p][~m]
    return (tuple(place(a, device) for a in (ri, ci, vi)),
            tuple(place(a, device) for a in (rb, cb, vb)))


def _remote_refs(pgraph: PartitionedGraph):
    """(dst_part, src_part, col) triples of the live remote references."""
    P = pgraph.n_parts
    R = pgraph.rows_per_part
    cols = host(pgraph.cols).ravel().astype(np.int64)
    vals = host(pgraph.vals).ravel()
    dst = np.repeat(np.arange(P, dtype=np.int64), pgraph.edges_per_part)
    src = np.minimum(cols // R, P - 1)
    remote = (vals != 0) & (src != dst)
    return dst[remote], src[remote], cols[remote]


def pair_width_matrix(pgraph: PartitionedGraph) -> np.ndarray:
    """[P, P] unique remote-column counts: W[dst, src] = rows dst needs
    from src. The diagonal is 0 (local rows are not exchanged)."""
    P = pgraph.n_parts
    R = pgraph.rows_per_part
    dst, src, cols = _remote_refs(pgraph)
    key = (dst * P + src) * (np.int64(P) * R) + cols
    counts = np.bincount(np.unique(key) // (np.int64(P) * R),
                         minlength=P * P)
    return counts.reshape(P, P)


def host_union_widths(pgraph: PartitionedGraph,
                      n_hosts: int) -> np.ndarray:
    """[n_hosts, P] unique columns needed from src part by ANY part on
    the dst host (contiguous parts per host: part p lives on host p//D):
    the cross-host volume of a hierarchical exchange."""
    P = pgraph.n_parts
    if P % n_hosts:
        raise ValueError(f"{P} parts not divisible by {n_hosts} hosts")
    D = P // n_hosts
    R = pgraph.rows_per_part
    dst, src, cols = _remote_refs(pgraph)
    key = ((dst // D) * P + src) * (np.int64(P) * R) + cols
    counts = np.bincount(np.unique(key) // (np.int64(P) * R),
                         minlength=n_hosts * P)
    return counts.reshape(n_hosts, P)


def halo_stats(pgraph: PartitionedGraph) -> dict:
    """Mean and max unique-remote-column counts over (dst, src) pairs and
    the padding factor max/mean (the cost of one all_to_all width)."""
    P = pgraph.n_parts
    counts = pair_width_matrix(pgraph)
    off_diag = counts[~np.eye(P, dtype=bool)]
    mean_w = float(off_diag.mean()) if off_diag.size else 0.0
    max_w = int(off_diag.max()) if off_diag.size else 0
    return {
        "mean_pair_width": mean_w,
        "max_pair_width": max_w,
        "padding_factor": (max_w / mean_w) if mean_w > 0 else 1.0,
    }


def halo_fraction(halo: HaloDescriptor, pgraph: PartitionedGraph) -> float:
    """Fraction of the padded node count exchanged per hop (< 1 wins)."""
    return halo.n_parts * halo.halo_width / pgraph.n_rows_padded


# ------------------------------------------------------------ device side


@dataclasses.dataclass(eq=False)
class LocalCsr:
    """One rank's edges as a kernel-B graph on its device: the live edges
    (val != 0; padding adds exact zeros, so leaving it out changes no
    sum) sorted by (row, col), with CSR row pointers. ``chunks(n)`` are
    the graphs of consecutive ranges of ``n`` sorted edges (views of the
    same arrays, row pointers clipped), built once per size;
    ``transposed()`` the transpose, built once."""

    graph: SparseGraph
    _chunks: dict = dataclasses.field(default_factory=dict)
    _transposed: "LocalCsr | None" = None

    def transposed(self) -> "LocalCsr":
        """The transpose as a LocalCsr on the same device (built on the
        host the first time, then kept): the backward of a product
        over these edges."""
        if self._transposed is None:
            self._transposed = LocalCsr(self.graph.transpose())
        return self._transposed

    def chunks(self, edge_chunk: int) -> list:
        got = self._chunks.get(edge_chunk)
        if got is None:
            g = self.graph
            got = []
            for s in range(0, max(g.nnz, 1), edge_chunk):
                e = min(s + edge_chunk, g.nnz)
                got.append(SparseGraph(
                    rows=g.rows[s:e], cols=g.cols[s:e], vals=g.vals[s:e],
                    row_ptr=(g.row_ptr.clamp(s, e) - s).to(torch.int32),
                    n_rows=g.n_rows, n_cols=g.n_cols, nnz=e - s))
            self._chunks[edge_chunk] = got
        return got


def local_csr(rows, cols, vals, n_rows: int, n_cols: int,
              device) -> LocalCsr:
    """A part's (rows, cols, vals) edge list as a :class:`LocalCsr` on
    ``device``."""
    rows, cols, vals = host(rows), host(cols), host(vals)
    live = vals != 0
    r, c, v = native.sort_edges(rows[live], cols[live], vals[live],
                                n_rows, n_cols)
    g = SparseGraph(rows=r.astype(np.int32), cols=c.astype(np.int32),
                    vals=v, row_ptr=native.row_ptr_from_sorted(
                        r, n_rows).astype(np.int32),
                    n_rows=int(n_rows), n_cols=int(n_cols), nnz=len(r))
    return LocalCsr(g.to(device))


def segment_spmm(csr: LocalCsr, x: torch.Tensor,
                 edge_chunk: int | None = None,
                 dense: torch.Tensor | None = None) -> torch.Tensor:
    """``dense + A @ x`` through kernel B (its plain version on a CPU
    tensor). ``edge_chunk``: one launch per range of that many sorted
    edges, each adding into the running sum in chunk order; with
    ``dense`` the first launch adds it, as the reference's chunked scan
    starts from its accumulator."""
    x = x.contiguous()
    if not edge_chunk:
        return spmm_segment(csr.graph, x, dense)
    acc = dense
    for g in csr.chunks(edge_chunk):
        acc = spmm_segment(g, x, acc)
    return acc


@dataclasses.dataclass(frozen=True, eq=False)
class LocalHalo:
    """Rank p's device view of a halo plan: ``send_idx[p]`` flattened
    (int64 ``[P * H]``) and its edges as kernel-B graphs: ``table``
    (columns in ``[0, R + P * H)``) for the single-exchange hop, or
    ``interior`` (``[0, R)``) and ``boundary`` (``[0, P * H)``) for the
    overlapped one."""

    send_idx: torch.Tensor
    rows_per_part: int
    table: LocalCsr | None = None
    interior: LocalCsr | None = None
    boundary: LocalCsr | None = None


def local_halo(mesh: Mesh, pgraph: PartitionedGraph,
               halo: HaloDescriptor) -> LocalHalo:
    """Place rank ``mesh``'s part of ``halo`` on its device (once per
    plan: ``parallel/spmm.py`` caches it)."""
    p, dev = mesh.coords[NODES_AXIS], mesh.device
    R, PH = pgraph.rows_per_part, halo.n_parts * halo.halo_width
    send = torch.as_tensor(host(halo.send_idx[p]).reshape(-1).astype(
        np.int64), device=dev)
    if halo.overlapped:
        ri, ci, vi = (host(a[p]) for a in halo.edges_int)
        rb, cb, vb = (host(a[p]) for a in halo.edges_bnd)
        return LocalHalo(send, R,
                         interior=local_csr(ri, ci, vi, R, R, dev),
                         boundary=local_csr(rb, cb, vb, R, PH, dev))
    return LocalHalo(send, R, table=local_csr(
        host(pgraph.rows_local[p]), host(halo.cols_halo[p]),
        host(pgraph.vals[p]), R, R + PH, dev))


def pack(x_local: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
    """The rows this rank sends, ``[P * H, F]`` (block q for rank q)."""
    return x_local.index_select(0, send_idx)


def exchange_and_spmm_overlapped(mesh: Mesh, local: LocalHalo,
                                 x_local: torch.Tensor,
                                 edge_chunk: int | None = None
                                 ) -> torch.Tensor:
    """One halo-exchanged hop with the exchange in flight during the
    interior term: the all_to_all starts (``async_op=True``), kernel B
    runs over the interior edges (``x_local`` only), then the wait, then
    kernel B over the boundary edges adds into the interior sum."""
    pending = mesh.all_to_all(NODES_AXIS, pack(x_local, local.send_idx),
                              async_op=True)
    acc = segment_spmm(local.interior, x_local, edge_chunk)
    halo = pending.wait()
    return segment_spmm(local.boundary, halo, edge_chunk, dense=acc)


def exchange_and_spmm(mesh: Mesh, local: LocalHalo, x_local: torch.Tensor,
                      edge_chunk: int | None = None) -> torch.Tensor:
    """One halo-exchanged hop: pack, all_to_all, then kernel B over the
    gather table ``[x_local; halo]``."""
    halo = mesh.all_to_all(NODES_AXIS, pack(x_local, local.send_idx))
    table = torch.cat([x_local, halo])
    return segment_spmm(local.table, table, edge_chunk)
