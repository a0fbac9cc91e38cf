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
launches the kernel (counted in ``LAUNCHES`` and ``BY_MODE``) or raises;
on a CPU tensor it runs :func:`edge_accumulate_plain`, which applies
the same updates in rounds (round k takes each row's k-th edge, so the
rows of one round are distinct).
"""

from __future__ import annotations

import torch

from sgc_tpu_torch.ops import kernels

MODES = ("rmw", "store", "fixed_out", "fixed_in", "noop")
# the kernel's mode bits: 1 every edge on row 0, 2 every edge reads x row
# 0, 4 assign instead of add
_MODE_BITS = {"rmw": 0, "store": 4, "fixed_out": 1, "fixed_in": 2,
              "noop": 3}
# rows of out a CTA keeps in shared memory (32 features of each)
ROWS_PER_CTA = 256

LAUNCHES = 0
BY_MODE = {m: 0 for m in MODES}


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


def edge_accumulate(rows, cols, vals, x, n_rows: int,
                    mode: str = "rmw") -> torch.Tensor:
    """The ``(n_rows, F)`` f32 result of the edges' updates in edge order
    (rows, cols int32, vals f32, ``x [W, F]`` f32): kernel G on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check(rows, cols, vals, x, n_rows, mode)
    if x.device.type == "cpu":
        return edge_accumulate_plain(rows, cols, vals, x, n_rows, mode)
    global LAUNCHES
    kernels.require_cuda_f32(x, "x")
    rows, cols, vals = rows.contiguous(), cols.contiguous(), vals.contiguous()
    F = int(x.shape[1])
    out = torch.empty((n_rows, F), dtype=torch.float32, device=x.device)
    if F == 0:
        return out
    rc = kernels.entry("edge_accumulate")(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
        out.data_ptr(), rows.shape[0], n_rows, x.shape[0], F,
        min(n_rows, ROWS_PER_CTA), _MODE_BITS[mode], kernels.stream_of(x))
    kernels.check_launch(rc, "edge_accumulate")
    LAUNCHES += 1
    BY_MODE[mode] += 1
    return out
