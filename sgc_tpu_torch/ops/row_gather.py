"""Kernel F, the row gather ``out[i, :] = x[idx[i], :]``
(``csrc/row_gather.cu``).

The counterpart of the Pallas kernels of ``scripts/exp_take_probe.py``
(an in-kernel vectorized gather in three JAX spellings, ``jnp.take``,
``x[idx]`` and ``take_along_axis``: one function) and
``scripts/exp_dma_gather_probe.py`` (one asynchronous DMA a row at an
offset read at run time). Two entries of one function:

* ``"load"``: a persistent grid of warps, each taking ``U`` rows a round
  and issuing all of their 16-byte loads before any store; the table is
  read under an L2 evict-last policy, the output written with streaming
  stores;
* ``"async"``: rows through a ring of ``in_flight`` (1, 2, 4, 8 or 16)
  row slots in shared memory, each row one bulk copy in (TMA, completing
  on the slot's mbarrier) and one bulk copy out; when F is not a multiple
  of 4 or an operand does not start on 16 bytes, 4-byte ``cp.async``
  copies instead.

:func:`gather_plan` chooses the path, grid, threads, rows a round and
shared memory of a launch; the C entries take the plan as arguments and
refuse one they do not compile, and :func:`plan_rows` lists the rows each
warp or CTA of a plan copies, in the kernel's order.

On a CUDA tensor :func:`row_gather` launches the kernel (counted once as
``launch.row_gather_<entry>``) or raises; on a CPU tensor it runs
:func:`row_gather_plain`. Both copy bits, so they agree exactly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.utils.profiling import count

ENTRIES = ("load", "async")
IN_FLIGHT = (1, 2, 4, 8, 16)
DEFAULT_IN_FLIGHT = 8

# what csrc/row_gather.cu compiles
LOAD_THREADS = 256
LOAD_MIN_CTAS = 4       # CTAs an SM that __launch_bounds__ guarantees
LOAD_K = 8              # vectors a lane holds in flight
BULK_THREADS = 32
CP_MAX_THREADS = 256
MAX_SMEM = 232448       # shared memory a CTA may use (bytes)
# one H100 SM: shared memory, the 1 KB the system keeps a CTA, resident
# CTAs and threads
SM_SMEM = 233472
CTA_RESERVED_SMEM = 1024
SM_MAX_CTAS = 32
SM_MAX_THREADS = 2048
H100_SMS = 132


@dataclass(frozen=True)
class GatherPlan:
    """One launch of kernel F. ``path``: ``"load"``, ``"bulk"`` (TMA) or
    ``"cp_async"``; ``vec``: floats a vector (4 or 1); ``grid`` CTAs of
    ``threads``; ``rows_per_round``: rows a warp's round (load) or rows in
    flight a CTA (bulk, cp_async); ``slot_bytes``: bytes a ring slot;
    ``smem_bytes``: dynamic shared memory a CTA."""

    path: str
    vec: int
    grid: int
    threads: int
    rows_per_round: int
    slot_bytes: int
    smem_bytes: int


def _ctas_per_sm(threads: int, smem: int) -> int:
    return min(SM_MAX_CTAS, SM_MAX_THREADS // threads,
               SM_SMEM // (smem + CTA_RESERVED_SMEM))


@functools.lru_cache(maxsize=256)
def gather_plan(n_out: int, F: int, entry: str = "load",
                in_flight: int = DEFAULT_IN_FLIGHT, aligned: bool = True,
                sms: int = H100_SMS, *, load_k: int = LOAD_K,
                load_ctas: int = LOAD_MIN_CTAS) -> GatherPlan:
    """The launch of ``n_out`` rows of ``F`` floats through ``entry``
    (``in_flight`` rows a CTA for ``"async"``), when x and out both start
    on 16 bytes (``aligned``), on a card of ``sms`` SMs. The grid is at
    most one wave. ``load_k`` and ``load_ctas`` override the compiled
    constants for variants of the kernel."""
    if n_out < 1 or F < 1:
        raise ValueError(f"no rows to gather: n_out={n_out}, F={F}")
    vec = 4 if F % 4 == 0 and aligned else 1
    if entry == "load":
        w = F // vec                              # vectors a row
        u = max(1, min(32, 32 * load_k // w))
        rounds = -(-n_out // u)
        grid = min(sms * load_ctas, -(-rounds // (LOAD_THREADS // 32)))
        return GatherPlan("load", vec, grid, LOAD_THREADS, u, 0, 0)
    if entry != "async" or in_flight not in IN_FLIGHT:
        raise ValueError(f"no plan for entry {entry!r} at in_flight "
                         f"{in_flight}")
    if vec == 4:
        slot = F * 4
        smem = in_flight * (slot + 8)             # slots, then mbarriers
        path, threads = "bulk", BULK_THREADS
    else:
        slot = F * 4
        smem = in_flight * slot
        path = "cp_async"
        threads = min(CP_MAX_THREADS, max(32, -(-F // 32) * 32))
    if smem > MAX_SMEM:
        raise ValueError(f"{in_flight} rows of {F} floats need {smem} bytes "
                         f"of shared memory, over {MAX_SMEM}")
    grid = min(n_out, sms * _ctas_per_sm(threads, smem))
    return GatherPlan(path, vec, grid, threads, in_flight, slot, smem)


def plan_rows(plan: GatherPlan, n_out: int) -> list[np.ndarray]:
    """The output rows each warp (load) or CTA (bulk, cp_async) of
    ``plan`` copies, in the order the kernel walks them."""
    if plan.path == "load":
        u = plan.rows_per_round
        n_warps = plan.grid * plan.threads // 32
        rounds = np.arange(-(-n_out // u))
        out = []
        for w in range(n_warps):
            rows = (rounds[w::n_warps, None] * u + np.arange(u)).ravel()
            out.append(rows[rows < n_out])
        return out
    if plan.path == "bulk":
        per = -(-n_out // plan.grid)
        return [np.arange(b * per, min(n_out, (b + 1) * per))
                for b in range(plan.grid)]
    return [np.arange(b, n_out, plan.grid) for b in range(plan.grid)]


_SMS: dict[int, int] = {}
_FNS: dict = {}


def _fn(symbol: str):
    fn = _FNS.get(symbol)
    if fn is None:
        fn = _FNS[symbol] = kernels.entry("row_gather", symbol)
    return fn


def sms_of(t: torch.Tensor) -> int:
    """The SM count of t's card (asked once a device)."""
    i = t.get_device()
    n = _SMS.get(i)
    if n is None:
        n = _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return n


def launch_gather(x: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                  plan: GatherPlan, lib=None) -> None:
    """One launch of kernel F into ``out`` under ``plan``; ``lib`` is
    another build of the plan's C entry (the A/B tool's variants),
    default the package's. Raises when the launch fails."""
    n_out, F = out.shape
    if plan.path == "load":
        rc = (lib or _fn("row_gather_load"))(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out, F,
            x.shape[0], plan.vec, plan.grid, plan.threads,
            plan.rows_per_round, kernels.stream_of(x))
    else:
        rc = (lib or _fn("row_gather_async"))(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out, F,
            x.shape[0], plan.rows_per_round, int(plan.path == "bulk"),
            plan.grid, plan.threads, plan.smem_bytes, kernels.stream_of(x))
    if rc:
        kernels.check_launch(rc, f"row_gather ({plan.path})")


def _check(x: torch.Tensor, idx: torch.Tensor, entry: str,
           in_flight: int) -> None:
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}; one of {ENTRIES}")
    if in_flight not in IN_FLIGHT:
        raise ValueError(f"in_flight must be one of {IN_FLIGHT}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError("idx must be a 1-D int32 tensor")
    if idx.get_device() != x.get_device():
        raise ValueError(f"idx on {idx.device}, x on {x.device}")


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


def row_gather(x: torch.Tensor, idx: torch.Tensor, entry: str = "load",
               in_flight: int = DEFAULT_IN_FLIGHT) -> torch.Tensor:
    """``x[idx]`` (x f32 ``[n, F]``, idx int32): kernel F through
    ``entry`` on a CUDA tensor, the plain version on a CPU tensor."""
    _check(x, idx, entry, in_flight)
    if not x.is_cuda and x.device.type == "cpu":
        return row_gather_plain(x, idx)
    kernels.require_cuda_f32(x, "x")
    idx = idx.contiguous()
    n_out, F = idx.shape[0], x.shape[1]
    out = x.new_empty((n_out, F))
    if n_out == 0 or F == 0:
        return out
    # out is fresh from the caching allocator, so on 16 bytes
    plan = gather_plan(n_out, F, entry, in_flight, x.data_ptr() % 16 == 0,
                       sms_of(x))
    launch_gather(x, idx, out, plan)
    count(f"launch.row_gather_{entry}")
    return out
