"""Kernel G, per-edge gather-accumulate in edge order
(``csrc/edge_accumulate.cu``).

The counterpart of the Pallas kernel of ``scripts/exp_gather_probe.py``:
an ``(R, F)`` output, zero at the start, and for each edge ``(r, c, v)``
in order one update of a row by a scaled row of ``x [W, F]``. The mode
picks the update (the reference's ``--mode``):

==========  =========================
``rmw``     ``out[r] += v * x[c]``
``store``   ``out[r] = v * x[c]``
``fixed_out``  ``out[0] += v * x[c]``
``fixed_in``   ``out[r] += v * x[0]``
``noop``    ``out[0] += v * x[0]``
==========  =========================

Every row's updates are applied in edge order, a product and then an add
each rounded to f32, so the result is the sequential loop's; ``store``
keeps each row's last edge. On a CUDA tensor :func:`edge_accumulate`
launches the kernel (one call of its C entry, four bucket launches and
one or two accumulate launches, counted once as
``launch.edge_accumulate`` and ``within.edge_accumulate.<mode>``) or
raises; on a CPU tensor it runs
:func:`edge_accumulate_plain`, which applies the same updates in rounds
(round k takes each row's k-th edge, so the rows of one round are
distinct).

The kernel first buckets the edges by effective row: a stable
permutation and ``row_ptr`` (:func:`bucket_edges`, whose plain version
:func:`bucket_edges_plain` is the definition: a stable argsort of the
effective rows and their counts' prefix sums), then walks each row's
bucket in order (:func:`accumulate_buckets`). Both passes can be
launched alone (counted as ``launch.edge_buckets`` and
``launch.edge_accumulate_bucketed``), to time them apart.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.utils.profiling import count

MODES = ("rmw", "store", "fixed_out", "fixed_in", "noop")
# the kernel's mode bits: 1 every edge on row 0, 2 every edge reads x row
# 0, 4 assign instead of add
_MODE_BITS = {"rmw": 0, "store": 4, "fixed_out": 1, "fixed_in": 2,
              "noop": 3}
# edges a chunk of the bucket pass (the kernel's CH, which it checks)
BUCKET_CHUNK = 512
# edges above which a row is heavy (the kernel's HEAVY): its features'
# chains take the kernel's deep-pipelined launch
HEAVY = 512



def _check(rows, cols, vals, x, n_rows: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if n_rows <= 0:
        raise ValueError("n_rows must be positive")
    for name, t, dtype in (("rows", rows, torch.int32),
                           ("cols", cols, torch.int32),
                           ("vals", vals, torch.float32)):
        if t.dim() != 1 or t.dtype != dtype or t.shape != rows.shape:
            raise ValueError(f"{name} must be 1-D {dtype} of the edges' "
                             "length")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def effective_edges(rows, cols, mode: str):
    """The rows and columns the mode's updates use (``fixed_out`` and
    ``noop`` put every edge on row 0, ``fixed_in`` and ``noop`` read x
    row 0)."""
    bits = _MODE_BITS[mode]
    r = torch.zeros_like(rows) if bits & 1 else rows
    c = torch.zeros_like(cols) if bits & 2 else cols
    return r, c


def edge_accumulate_plain(rows, cols, vals, x, n_rows: int,
                          mode: str = "rmw") -> torch.Tensor:
    _check(rows, cols, vals, x, n_rows, mode)
    r, c = effective_edges(rows.long(), cols.long(), mode)
    out = x.new_zeros((n_rows, x.shape[1]))
    if r.numel() == 0:
        return out
    # each edge's rank among its row's edges, in edge order
    order = torch.argsort(r, stable=True)
    r_sorted = r[order]
    starts = torch.ones_like(r_sorted, dtype=torch.bool)
    starts[1:] = r_sorted[1:] != r_sorted[:-1]
    first = torch.cummax(torch.where(
        starts, torch.arange(len(r_sorted), device=r.device),
        torch.zeros_like(r_sorted)), 0).values
    rank = torch.empty_like(r)
    rank[order] = torch.arange(len(r_sorted), device=r.device) - first
    by_round = torch.argsort(rank, stable=True)
    counts = torch.bincount(rank).tolist()
    store = mode == "store"
    pos = 0
    for n in counts:
        e = by_round[pos:pos + n]
        pos += n
        p = vals[e].unsqueeze(1) * x[c[e]]
        out[r[e]] = p if store else out[r[e]] + p
    return out


@dataclasses.dataclass(frozen=True)
class Buckets:
    """The edges bucketed by effective row: ``perm`` the stable
    permutation (edge ids, row by row, each row's in edge order),
    ``row_ptr`` each row's start in it; ``cols``/``vals`` the edges'
    effective columns and values in that order; ``heavy`` the rows with
    more than ``HEAVY`` edges, in row order (none in store mode), their
    count in ``n_heavy``."""

    row_ptr: torch.Tensor   # int32 [R + 1]
    perm: torch.Tensor      # int32 [E]
    cols: torch.Tensor      # int32 [E]
    vals: torch.Tensor      # f32 [E]
    heavy: torch.Tensor     # int32 [R], the first n_heavy valid
    n_heavy: torch.Tensor   # int32 [1]
    local_rank: torch.Tensor  # int32 [E]: the kernel's scratch
    offs: torch.Tensor        # int32 [chunks, R]: the kernel's scratch


def bucket_edges_plain(rows, cols, vals, n_rows: int,
                       mode: str = "rmw") -> Buckets:
    """The bucket pass's definition: a stable argsort of the effective
    rows, ``row_ptr`` the exclusive prefix sum of their counts."""
    r, c = effective_edges(rows.long(), cols.long(), mode)
    perm = torch.argsort(r, stable=True)
    counts = torch.bincount(r, minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=r.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    heavy = torch.zeros(n_rows, dtype=torch.int32, device=r.device)
    hv = (torch.nonzero(counts > HEAVY).flatten() if mode != "store"
          else counts.new_zeros(0))
    heavy[: hv.numel()] = hv.to(torch.int32)
    return Buckets(row_ptr=row_ptr.to(torch.int32),
                   perm=perm.to(torch.int32), cols=c[perm].to(torch.int32),
                   vals=vals[perm], heavy=heavy,
                   n_heavy=torch.tensor([hv.numel()], dtype=torch.int32,
                                        device=r.device),
                   local_rank=r.new_zeros(0, dtype=torch.int32),
                   offs=r.new_zeros(0, dtype=torch.int32))


# the scratch's parts in one int32 allocation, and the order in which the
# C entries take them (local_rank, offs, row_ptr, heavy, n_heavy, perm,
# scol, sval)
_PARTS = ("offs", "row_ptr", "perm", "cols", "vals", "heavy", "n_heavy",
          "local_rank")
_C_ORDER = (7, 0, 1, 5, 6, 2, 3, 4)


def _sizes(n_edges: int, n_rows: int) -> tuple[int, ...]:
    chunks = -(-n_edges // BUCKET_CHUNK)
    return (chunks * n_rows, n_rows + 1, n_edges, n_edges, n_edges, n_rows,
            1, n_edges)


def _scratch(n_edges: int, n_rows: int,
             device) -> tuple[torch.Tensor, tuple[int, ...]]:
    """The kernel's scratch, one int32 allocation, and the C entries'
    pointers into it."""
    sizes = _sizes(n_edges, n_rows)
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=device)
    starts = tuple(itertools.accumulate((0,) + sizes[:-1]))
    base = buf.data_ptr()
    return buf, tuple(base + 4 * starts[i] for i in _C_ORDER)


def _buckets_of(buf: torch.Tensor, n_edges: int, n_rows: int) -> Buckets:
    """The scratch's parts as a :class:`Buckets`."""
    sizes = _sizes(n_edges, n_rows)
    parts = dict(zip(_PARTS, buf.split(sizes)))
    parts["vals"] = parts["vals"].view(torch.float32)
    parts["offs"] = parts["offs"].view(-1, n_rows)
    return Buckets(**parts)


def _launch_args(rows, cols, vals, x):
    """The edges made contiguous for a launch, x checked for one."""
    kernels.require_cuda_f32(x, "x")
    return rows.contiguous(), cols.contiguous(), vals.contiguous()


def bucket_edges(rows, cols, vals, x, n_rows: int,
                 mode: str = "rmw") -> Buckets:
    """The bucket pass alone (x gives the column range and the device):
    kernel G's four bucket launches on a CUDA tensor, counted once as
    ``launch.edge_buckets``; the plain version on a CPU tensor."""
    _check(rows, cols, vals, x, n_rows, mode)
    if x.device.type == "cpu":
        return bucket_edges_plain(rows, cols, vals, n_rows, mode)
    rows, cols, vals = _launch_args(rows, cols, vals, x)
    E = int(rows.shape[0])
    buf, ptrs = _scratch(E, n_rows, x.device)
    rc = kernels.entry("edge_accumulate", "edge_buckets")(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), E, n_rows,
        x.shape[0], _MODE_BITS[mode], BUCKET_CHUNK, *ptrs,
        kernels.stream_of(x))
    kernels.check_launch(rc, "edge_buckets")
    count("launch.edge_buckets")
    return _buckets_of(buf, E, n_rows)


def accumulate_buckets(b: Buckets, x, n_rows: int,
                       mode: str = "rmw") -> torch.Tensor:
    """The accumulate pass alone on :func:`bucket_edges`'s output (the
    same mode): the ``(n_rows, F)`` result, counted as
    ``launch.edge_accumulate_bucketed``; on a CPU tensor the plain version
    of the same updates."""
    if x.device.type == "cpu":
        # the bucket's rows and columns are the effective ones already
        return edge_accumulate_plain(_rows_of(b, n_rows), b.cols, b.vals, x,
                                     n_rows,
                                     "store" if mode == "store" else "rmw")
    kernels.require_cuda_f32(x, "x")
    F = int(x.shape[1])
    out = torch.empty((n_rows, F), dtype=torch.float32, device=x.device)
    if F == 0:
        return out
    rc = kernels.entry("edge_accumulate", "edge_accumulate_bucketed")(
        b.row_ptr.data_ptr(), b.heavy.data_ptr(), b.n_heavy.data_ptr(),
        b.cols.data_ptr(), b.vals.data_ptr(), x.data_ptr(), out.data_ptr(),
        b.cols.shape[0], n_rows, x.shape[0], F, _MODE_BITS[mode],
        kernels.stream_of(x))
    kernels.check_launch(rc, "edge_accumulate_bucketed")
    count("launch.edge_accumulate_bucketed")
    return out


def _rows_of(b: Buckets, n_rows: int) -> torch.Tensor:
    """Each bucketed edge's row (int32), from ``row_ptr``."""
    counts = (b.row_ptr[1:] - b.row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n_rows, dtype=torch.int32, device=counts.device),
        counts)


def edge_accumulate(rows, cols, vals, x, n_rows: int,
                    mode: str = "rmw") -> torch.Tensor:
    """The ``(n_rows, F)`` f32 result of the edges' updates in edge order
    (rows, cols int32, vals f32, ``x [W, F]`` f32): kernel G on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check(rows, cols, vals, x, n_rows, mode)
    if x.device.type == "cpu":
        return edge_accumulate_plain(rows, cols, vals, x, n_rows, mode)
    rows, cols, vals = _launch_args(rows, cols, vals, x)
    F = int(x.shape[1])
    out = torch.empty((n_rows, F), dtype=torch.float32, device=x.device)
    if F == 0:
        return out
    buf, ptrs = _scratch(int(rows.shape[0]), n_rows, x.device)
    rc = kernels.entry("edge_accumulate")(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
        out.data_ptr(), rows.shape[0], n_rows, x.shape[0], F,
        _MODE_BITS[mode], BUCKET_CHUNK, *ptrs, kernels.stream_of(x))
    del buf   # freed in stream order, after the launches
    kernels.check_launch(rc, "edge_accumulate")
    count("launch.edge_accumulate")
    count(f"within.edge_accumulate.{mode}")
    return out
