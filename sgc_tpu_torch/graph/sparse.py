"""Sparse graph container (the counterpart of sgc_tpu/graph/sparse.py).

A row-sorted COO edge list (``rows``, ``cols``, ``vals``) with CSR
``row_ptr`` offsets, held either as host numpy arrays (what the host prep
builds) or as tensors on one device (after :meth:`SparseGraph.to`).

Padding: the edge arrays keep the reference's padding to a multiple of
1024 edges (``EDGE_PAD_MULTIPLE``). Padding edges point at the last row
and column with value 0 and live in ``[nnz, E_pad)``. The CUDA kernels
read only the first ``nnz`` edges through ``row_ptr``, so the padding is
not needed on the card; it is kept so that every host array of the port
compares bit for bit with the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch import native
from sgc_tpu_torch.utils.device import resolve_device

EDGE_PAD_MULTIPLE = 1024


def pad_edges_to(n: int, multiple: int = EDGE_PAD_MULTIPLE) -> int:
    """Round ``n`` up to a multiple of ``multiple`` (minimum one tile)."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def host(a) -> np.ndarray:
    """A numpy view of a host array or a copy of a tensor."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class RowWalk:
    """A graph's rows in another order for kernel B: ``row_ptr``,
    ``cols`` and ``vals`` are the graph's CSR with its rows permuted
    (each row's edges in their own order, column ids unchanged), and
    row r of it is the graph's row ``row_map[r]`` (int32)."""

    row_ptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    row_map: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """Row-sorted COO matrix with CSR row pointers.

    Attributes:
      rows:    int32[E_pad], non-decreasing.
      cols:    int32[E_pad].
      vals:    float32[E_pad], exactly 0 on padding edges.
      row_ptr: int32[n_rows + 1], offsets into the unpadded edges.
      n_rows, n_cols: the matrix shape.
      nnz:     the true edge count; padding lives in ``[nnz, E_pad)``.
      walk, prepared_transpose: set by ``ops.autograd.prepare_operator``
               alone, else None: the rows in kernel B's walked order
               (:class:`RowWalk`) and the transpose carrying these values
               (with its own walk). ``with_vals`` of the very same values
               keeps them; every other constructor drops them.
    """

    rows: np.ndarray | torch.Tensor
    cols: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    row_ptr: np.ndarray | torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int
    walk: RowWalk | None = None
    prepared_transpose: "SparseGraph | None" = None

    @property
    def n_edges_padded(self) -> int:
        return int(self.rows.shape[0])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device | None:
        """The tensors' device, or None for a host (numpy) graph."""
        return self.rows.device if torch.is_tensor(self.rows) else None

    # ---------------------------------------------------------------- build

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n_rows: int,
        n_cols: int,
        pad_multiple: int = EDGE_PAD_MULTIPLE,
        presorted: bool = False,
    ) -> "SparseGraph":
        """Build a host graph from COO arrays; sorts by (row, col) and pads.

        ``presorted=True`` skips the sort for inputs already in (row, col)
        order, after a vectorized check that raises on a violation.
        """
        if len(rows) > np.iinfo(np.int32).max:
            raise ValueError(f"{len(rows)} edges overflow int32 offsets")
        if presorted:
            rows = np.ascontiguousarray(rows, dtype=np.int64)
            cols = np.ascontiguousarray(cols, dtype=np.int64)
            vals = np.ascontiguousarray(vals, dtype=np.float32)
            if n_cols > np.iinfo(np.int32).max:
                raise ValueError(f"n_cols {n_cols} overflows int32 indices")
            key = (rows << 32) | cols
            if len(key) and (key[1:] < key[:-1]).any():
                raise ValueError(
                    "presorted=True but edges are not (row, col)-sorted")
        else:
            rows, cols, vals = native.sort_edges(rows, cols, vals, n_rows,
                                                 n_cols)
        nnz = int(rows.shape[0])
        row_ptr = native.row_ptr_from_sorted(rows, n_rows).astype(np.int32)

        pad = pad_edges_to(nnz, pad_multiple) - nnz
        if pad:
            rows = np.concatenate([rows, np.full(pad, max(n_rows - 1, 0))])
            cols = np.concatenate([cols, np.full(pad, max(n_cols - 1, 0))])
            vals = np.concatenate([vals, np.zeros(pad, dtype=np.float32)])
        return SparseGraph(
            rows=np.asarray(rows, dtype=np.int32),
            cols=np.asarray(cols, dtype=np.int32),
            vals=np.asarray(vals, dtype=np.float32),
            row_ptr=row_ptr,
            n_rows=int(n_rows),
            n_cols=int(n_cols),
            nnz=nnz,
        )

    @staticmethod
    def from_scipy(mat, pad_multiple: int = EDGE_PAD_MULTIPLE
                   ) -> "SparseGraph":
        """Build a host graph from any scipy.sparse matrix; a CSR input
        with sorted indices takes the presorted path."""
        import scipy.sparse as sp

        presorted = bool(sp.issparse(mat) and mat.format == "csr"
                         and mat.has_sorted_indices)
        coo = mat.tocoo()
        return SparseGraph.from_coo(coo.row, coo.col, coo.data, coo.shape[0],
                                    coo.shape[1], pad_multiple,
                                    presorted=presorted)

    # ------------------------------------------------------------- convert

    def to(self, device=None) -> "SparseGraph":
        """The same graph with its arrays as tensors on ``device``
        (``None`` -> the CUDA card; raises without one)."""
        dev = resolve_device(device)
        return SparseGraph(
            rows=torch.as_tensor(self.rows, device=dev),
            cols=torch.as_tensor(self.cols, device=dev),
            vals=torch.as_tensor(self.vals, device=dev),
            row_ptr=torch.as_tensor(self.row_ptr, device=dev),
            n_rows=self.n_rows, n_cols=self.n_cols, nnz=self.nnz,
        )

    def to_scipy(self):
        import scipy.sparse as sp

        n = self.nnz
        return sp.coo_matrix(
            (host(self.vals)[:n], (host(self.rows)[:n], host(self.cols)[:n])),
            shape=self.shape)

    def transpose(self) -> "SparseGraph":
        """The transpose, re-sorted by its new rows; equal bit for bit to
        the reference's ``SparseGraph.transpose``."""
        return self.transpose_perm()[0]

    def transpose_perm(self):
        """``(transpose, perm)``: the transpose and the int32 permutation
        of the live edges with ``transpose.vals[:nnz] == vals[:nnz][perm]``
        (port only: the backward of a product over edge values that change
        every step gathers them through ``perm``).

        Built on the host by a stable sort of the edges on (col, row), the
        order the reference's radix sort gives; a graph on a device yields
        tensors on the same device.
        """
        nnz = self.nnz
        rows = host(self.rows)[:nnz].astype(np.int64)
        cols = host(self.cols)[:nnz].astype(np.int64)
        perm = np.argsort((cols << 32) | rows, kind="stable")
        gt = SparseGraph.from_coo(cols[perm], rows[perm],
                                  host(self.vals)[:nnz][perm], self.n_cols,
                                  self.n_rows, presorted=True)
        perm = perm.astype(np.int32)
        if self.device is None:
            return gt, perm
        return gt.to(self.device), torch.as_tensor(perm, device=self.device)

    def with_vals(self, vals) -> "SparseGraph":
        """Same sparsity pattern, new edge values: the graph itself when
        ``vals`` is the tensor it holds (a prepared operator stays
        prepared), else a graph without the preparation, which was made
        for the old values."""
        if vals is self.vals:
            return self
        return SparseGraph(rows=self.rows, cols=self.cols, vals=vals,
                           row_ptr=self.row_ptr, n_rows=self.n_rows,
                           n_cols=self.n_cols, nnz=self.nnz)

    def row_subgraph(self, row_indices: np.ndarray) -> "SparseGraph":
        """Keep only edges whose row is in ``row_indices``; rows are
        renumbered to positions in ``row_indices`` (columns unchanged), so
        ``spmm(g.row_subgraph(idx), x) == spmm(g, x)[idx]``.

        Built on the host; a graph on a device yields a subgraph on the
        same device.
        """
        row_indices = np.asarray(row_indices, dtype=np.int64)
        if len(np.unique(row_indices)) != len(row_indices):
            raise ValueError("row_subgraph requires unique row indices")
        if row_indices.size and (row_indices.min() < 0
                                 or row_indices.max() >= self.n_rows):
            raise ValueError(
                f"row indices must be in [0, {self.n_rows}); got range "
                f"[{row_indices.min()}, {row_indices.max()}]")
        lookup = np.full(self.n_rows, -1, dtype=np.int64)
        lookup[row_indices] = np.arange(len(row_indices))
        rows = host(self.rows)[: self.nnz]
        keep = lookup[rows] >= 0
        # a subset of (row, col)-sorted edges stays sorted when the row
        # renumbering is monotone (ascending row_indices)
        ascending = bool(np.all(np.diff(row_indices) > 0))
        sub = SparseGraph.from_coo(
            lookup[rows[keep]],
            host(self.cols)[: self.nnz][keep],
            host(self.vals)[: self.nnz][keep],
            len(row_indices),
            self.n_cols,
            presorted=ascending,
        )
        return sub if self.device is None else sub.to(self.device)

    # --------------------------------------------------------------- utils

    def _on_tensors(self) -> "SparseGraph":
        return self if self.device is not None else self.to("cpu")

    def degrees(self) -> torch.Tensor:
        """Weighted out-degree per row (padding edges contribute 0): kernel
        B with F = 1 against a column of ones (``ops.spmm.row_sums``),
        on the graph's device (the CPU for a host graph)."""
        from sgc_tpu_torch.ops.spmm import row_sums

        g = self._on_tensors()
        return row_sums(g, g.vals)

    def binary_degrees(self) -> torch.Tensor:
        """Unweighted degree per row: the edges whose value is nonzero."""
        from sgc_tpu_torch.ops.spmm import row_sums

        g = self._on_tensors()
        return row_sums(g, (g.vals != 0).float())


def save_graph(path, graph: SparseGraph) -> None:
    """Write a graph to one ``.npz``: the unpadded ``rows``, ``cols`` and
    ``vals`` and the int64 ``shape``, the reference's format (a file
    written by either package loads in the other)."""
    from pathlib import Path

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    n = graph.nnz
    np.savez_compressed(p, rows=host(graph.rows)[:n],
                        cols=host(graph.cols)[:n],
                        vals=host(graph.vals)[:n],
                        shape=np.asarray(graph.shape, np.int64))


def load_graph(path, pad_multiple: int = EDGE_PAD_MULTIPLE) -> SparseGraph:
    """A host graph from a file of :func:`save_graph`. A path without the
    ``.npz`` suffix that does not exist gets it appended, as numpy's
    ``savez`` did when writing."""
    from pathlib import Path

    p = Path(path)
    if p.suffix != ".npz" and not p.exists():
        p = p.with_suffix(p.suffix + ".npz")
    with np.load(p) as z:
        n_rows, n_cols = (int(x) for x in z["shape"])
        return SparseGraph.from_coo(z["rows"], z["cols"], z["vals"], n_rows,
                                    n_cols, pad_multiple)


def block_diag(graphs: list, pad_multiple: int = EDGE_PAD_MULTIPLE
               ) -> tuple[SparseGraph, np.ndarray]:
    """Batch square graphs into one block-diagonal host graph: one SpMM
    over it propagates every member on its own. Returns ``(graph,
    offsets)``, ``offsets[i]`` member i's first node id and
    ``offsets[-1]`` the node count. Raises for a non-square member."""
    rows, cols, vals = [], [], []
    offsets = [0]
    for g in graphs:
        if g.n_rows != g.n_cols:
            raise ValueError("block_diag requires square member graphs")
        off = offsets[-1]
        n = g.nnz
        rows.append(host(g.rows)[:n].astype(np.int64) + off)
        cols.append(host(g.cols)[:n].astype(np.int64) + off)
        vals.append(host(g.vals)[:n])
        offsets.append(off + g.n_rows)
    total = offsets[-1]
    out = SparseGraph.from_coo(
        np.concatenate(rows) if rows else np.zeros(0, np.int64),
        np.concatenate(cols) if cols else np.zeros(0, np.int64),
        np.concatenate(vals) if vals else np.zeros(0, np.float32),
        total, total, pad_multiple)
    return out, np.asarray(offsets)
