"""ctypes bindings for the host graph-prep library (``graphprep.cpp``).

The port's copy of the reference's C++ host library, built with ``g++``
at first use into ``build/sgc_tpu_torch/`` (utils/buildlib.py). Only the
calls the ported paths use are bound: ``sort_edges``,
``row_ptr_from_sorted``, ``coalesce``, ``lpa_labels``, ``cell_scatter``
(block-dense split), ``tile_fill`` (the tiled one-hot layout),
``slot_row_index`` (kernel C's row index of that layout, the port's own)
and ``sym_normalize_edges``.

Only ``sym_normalize_edges`` has a numpy twin, which it takes when the
library cannot be built: the twin gives the same bits. Every other call
raises without the library. The reference falls back silently (to a
synchronous numpy LPA, among others), and that fallback reaches a
different LPA fixpoint, so a different ordering, split and dense
fraction; the port refuses to change results that way.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from sgc_tpu_torch.utils.buildlib import BUILD_DIR, LibSpec, ensure_built

_SRC = Path(__file__).resolve().with_name("graphprep.cpp")
LIB_SPEC = LibSpec(
    source=_SRC,
    output=BUILD_DIR / "libgraphprep.so",
    command=("g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", "-pthread", str(_SRC)),
)

_lib = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64


def _load():
    """The loaded library, built first when stale. Raises when the build
    or the load fails."""
    global _lib
    if _lib is not None:
        return _lib
    ensure_built([LIB_SPEC])
    lib = ctypes.CDLL(str(LIB_SPEC.output))
    lib.sort_edges_by_row_col.argtypes = [_I64P, _I64P, _F32P, _I64, _I64,
                                          _I64]
    lib.sort_edges_by_row_col.restype = ctypes.c_int
    lib.build_row_ptr.argtypes = [_I64P, _I64, _I64, _I64P]
    lib.build_row_ptr.restype = ctypes.c_int
    lib.coalesce_sorted.argtypes = [_I64P, _I64P, _F32P, _I64]
    lib.coalesce_sorted.restype = _I64
    lib.lpa_labels.argtypes = [_I64P, _I64P, _I64, ctypes.c_int,
                               ctypes.c_double, _I64P]
    lib.lpa_labels.restype = ctypes.c_int
    lib.cell_scatter_bf16.argtypes = [_I64P, _I64P, _F32P, _I64, _I64P,
                                      _I64, _I64, _I64, _U16P, _U8P]
    lib.cell_scatter_bf16.restype = ctypes.c_int
    lib.tile_fill.argtypes = [_I64P, _I64P, _F32P, _I64, _I64P, _I64P,
                              _I64P, _I64, _I64, _I64, _I64, _I64, _I32P,
                              _I32P, _F32P]
    lib.tile_fill.restype = ctypes.c_int
    lib.slot_row_index.argtypes = [_I32P, _I32P, _I64, _I64, _I64, _I32P,
                                   _I32P]
    lib.slot_row_index.restype = ctypes.c_int
    lib.weighted_degrees.argtypes = [_I64P, _F32P, _I64, _I64, _F64P]
    lib.weighted_degrees.restype = ctypes.c_int
    lib.scale_sym_norm.argtypes = [_I64P, _I64P, _F32P, _I64, _F64P]
    lib.scale_sym_norm.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _p(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def sort_edges(rows, cols, vals, n_rows: int, n_cols: int):
    """Sort COO edges by (row, col) with the parallel radix sort. Returns
    new int64/int64/f32 arrays; the inputs are not mutated."""
    lib = _load()
    rows = np.array(rows, dtype=np.int64)
    cols = np.array(cols, dtype=np.int64)
    vals = np.array(vals, dtype=np.float32)
    lib.sort_edges_by_row_col(_p(rows, _I64P), _p(cols, _I64P),
                              _p(vals, _F32P), len(rows), n_rows, n_cols)
    return rows, cols, vals


def row_ptr_from_sorted(rows, n_rows: int) -> np.ndarray:
    """int64 CSR offsets (``n_rows + 1``) of row-sorted edges."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if len(rows) and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError(f"row ids must lie in [0, {n_rows})")
    out = np.zeros(n_rows + 1, dtype=np.int64)
    lib.build_row_ptr(_p(rows, _I64P), len(rows), n_rows, _p(out, _I64P))
    return out


def coalesce(rows, cols, vals):
    """Sum duplicates of a (row, col)-sorted edge list. Returns new
    arrays; the inputs are not mutated."""
    lib = _load()
    rows = np.array(rows, dtype=np.int64)
    cols = np.array(cols, dtype=np.int64)
    vals = np.array(vals, dtype=np.float32)
    n = lib.coalesce_sorted(_p(rows, _I64P), _p(cols, _I64P),
                            _p(vals, _F32P), len(rows))
    return rows[:n].copy(), cols[:n].copy(), vals[:n].copy()


def lpa_labels(row_ptr, cols, max_iter: int, min_moved_frac: float):
    """Asynchronous label propagation over a CSR graph: ascending sweep
    order, ties to the smallest label. Returns ``(labels int64[n],
    sweeps)``."""
    lib = _load()
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    n = len(row_ptr) - 1
    if len(cols) != row_ptr[-1] or (len(cols) and (
            cols.min() < 0 or cols.max() >= n)):
        raise ValueError("lpa_labels needs a square CSR graph")
    labels = np.arange(n, dtype=np.int64)
    sweeps = lib.lpa_labels(_p(row_ptr, _I64P), _p(cols, _I64P), n,
                            int(max_iter), float(min_moved_frac),
                            _p(labels, _I64P))
    return labels, int(sweeps)


def cell_scatter(rows, cols, vals, compact, n_st: int, row_block: int,
                 stripe: int, cells_flat: np.ndarray,
                 mask: np.ndarray) -> None:
    """Fused dense-cell scatter of ``split_block_dense``: writes the bf16
    bits of each dense edge's value (duplicate (row, col) runs summed in
    f32 first, then rounded to nearest even once) into ``cells_flat``, a
    pre-zeroed uint16 buffer, and sets ``mask[i] = 1`` for dense edges."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    compact = np.ascontiguousarray(compact, dtype=np.int64)
    if cells_flat.dtype != np.uint16 or not cells_flat.flags.c_contiguous:
        raise ValueError("cells_flat must be a contiguous uint16 buffer")
    if mask.dtype != np.uint8 or mask.shape != rows.shape:
        raise ValueError("mask must be uint8 with one entry per edge")
    n_slots = int(compact.max()) + 1 if len(compact) else 0
    if cells_flat.size < n_slots * row_block * stripe:
        raise ValueError("cells_flat is smaller than the admitted cells")
    lib.cell_scatter_bf16(_p(rows, _I64P), _p(cols, _I64P), _p(vals, _F32P),
                          len(rows), _p(compact, _I64P), int(n_st),
                          int(row_block), int(stripe),
                          _p(cells_flat, _U16P), _p(mask, _U8P))


def tile_fill(rows, cols, vals, cell, cell_start, counts, chunk: int,
              n_st: int, row_block: int, stripe: int, total_chunks: int):
    """Scatter (row, col)-sorted edges into the padded per-cell chunk
    layout of ``tile_graph`` (a stable counting sort by ``cell``, so the
    order within a cell is the input's). ``cell_start`` is in chunks,
    ``counts`` is each cell's edge count. Returns ``(rows int32, cols
    int32, vals f32)`` of length ``total_chunks * chunk``; padding slots
    carry the cell's base (row, col) and val 0."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    cell = np.ascontiguousarray(cell, dtype=np.int64)
    cell_start = np.ascontiguousarray(cell_start, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    if not (len(rows) == len(cols) == len(vals) == len(cell)):
        raise ValueError("rows, cols, vals and cell must have one entry "
                         "per edge")
    if len(cell_start) != len(counts):
        raise ValueError("cell_start and counts must have one entry per "
                         "cell")
    if len(cell) and (cell.min() < 0 or cell.max() >= len(counts)):
        raise ValueError(f"cell ids must lie in [0, {len(counts)})")
    if not np.array_equal(np.bincount(cell, minlength=len(counts)), counts):
        raise ValueError("counts must be the edge count of each cell")
    n_out = int(total_chunks) * int(chunk)
    if len(counts) and int(
            ((cell_start + -(-counts // chunk)) * chunk).max()) > n_out:
        raise ValueError("the cells' chunks overrun total_chunks")
    r_out = np.zeros(n_out, np.int32)
    c_out = np.zeros(n_out, np.int32)
    v_out = np.zeros(n_out, np.float32)
    lib.tile_fill(
        _p(rows, _I64P), _p(cols, _I64P), _p(vals, _F32P), len(rows),
        _p(cell, _I64P), _p(cell_start, _I64P), _p(counts, _I64P),
        len(counts), int(chunk), int(n_st), int(row_block), int(stripe),
        _p(r_out, _I32P), _p(c_out, _I32P), _p(v_out, _F32P))
    return r_out, c_out, v_out


def slot_row_index(rows, chunk_nnz, chunk: int, n_rows: int):
    """The edge slots of a tiled layout (each chunk's first
    ``chunk_nnz[k]`` slots) in (row, layout position) order, by a stable
    counting sort on the row. Returns ``(row_ptr int32[n_rows + 1], perm
    int32[edges])``."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    chunk_nnz = np.ascontiguousarray(chunk_nnz, dtype=np.int32)
    if len(rows) != len(chunk_nnz) * chunk:
        raise ValueError("rows must hold len(chunk_nnz) * chunk slots")
    if len(chunk_nnz) and (chunk_nnz.min() < 0 or chunk_nnz.max() > chunk):
        raise ValueError(f"chunk_nnz must lie in [0, {chunk}]")
    if len(rows) >= 2**31:
        raise ValueError("slot ids must fit int32")
    if len(rows) and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError(f"row ids must lie in [0, {n_rows})")
    edges = int(chunk_nnz.sum(dtype=np.int64))
    row_ptr = np.zeros(n_rows + 1, np.int32)
    perm = np.zeros(edges, np.int32)
    lib.slot_row_index(_p(rows, _I32P), _p(chunk_nnz, _I32P),
                       len(chunk_nnz), int(chunk), int(n_rows),
                       _p(row_ptr, _I32P), _p(perm, _I32P))
    return row_ptr, perm


def _sym_normalize_inputs(rows, cols, vals, n_rows: int):
    rows = np.array(rows, dtype=np.int64)
    cols = np.array(cols, dtype=np.int64)
    vals = np.array(vals, dtype=np.float32)
    if not len(rows) == len(cols) == len(vals):
        raise ValueError("rows, cols and vals must have one entry per edge")
    # the scaling indexes the degree vector with both endpoints
    if len(cols) and (cols.max() >= n_rows or cols.min() < 0):
        raise ValueError(
            f"sym_normalize_edges requires a square operator: col ids "
            f"must be in [0, {n_rows})")
    if len(rows) and (rows.max() >= n_rows or rows.min() < 0):
        raise ValueError(f"row ids must lie in [0, {n_rows})")
    return rows, cols, vals


def sym_normalize_edges(rows, cols, vals, n_rows: int):
    """``D^-1/2 A D^-1/2`` on an edge list, ``D`` the weighted row
    degrees (f64 sums in edge order), each value scaled in f64 and
    rounded to f32 once. Returns new ``(rows int64, cols int64, vals
    f32)``; the inputs are not mutated. Takes
    :func:`sym_normalize_edges_plain` when the library cannot be built
    (the same bits)."""
    if not available():
        return sym_normalize_edges_plain(rows, cols, vals, n_rows)
    lib = _load()
    rows, cols, vals = _sym_normalize_inputs(rows, cols, vals, n_rows)
    deg = np.zeros(n_rows, dtype=np.float64)
    lib.weighted_degrees(_p(rows, _I64P), _p(vals, _F32P), len(rows),
                         n_rows, _p(deg, _F64P))
    lib.scale_sym_norm(_p(rows, _I64P), _p(cols, _I64P), _p(vals, _F32P),
                       len(rows), _p(_inv_sqrt(deg), _F64P))
    return rows, cols, vals


def sym_normalize_edges_plain(rows, cols, vals, n_rows: int):
    """The numpy twin of :func:`sym_normalize_edges`."""
    rows, cols, vals = _sym_normalize_inputs(rows, cols, vals, n_rows)
    deg = np.zeros(n_rows, dtype=np.float64)
    np.add.at(deg, rows, vals.astype(np.float64))
    dinv = _inv_sqrt(deg)
    return rows, cols, (vals * dinv[rows] * dinv[cols]).astype(np.float32)


def _inv_sqrt(deg: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.ascontiguousarray(np.where(deg > 0, deg ** -0.5, 0.0))
