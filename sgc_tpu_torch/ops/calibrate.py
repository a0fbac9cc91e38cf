"""Measured admission-model rates (the counterpart of
sgc_tpu/ops/calibrate.py).

The block-dense admission crossover (``min_edges_for``) divides the cost
of one cell matmul by the sparse path's edge rate. The committed
constants were measured by the reference on a TPU v5e; on the card this
module measures both rates through the port's own kernels (kernel A for
the cell term, kernel B for the sparse path) with the reference's two
differenced probes, which cancel the fixed per-call cost. Results are
cached in-process and on disk under ``build/sgc_tpu_torch/``, keyed by the
device name. A CPU device never probes: it returns the committed
constants, so CPU runs stay deterministic. A failed probe raises; it
does not fall back to the constants.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sgc_tpu_torch.utils.buildlib import BUILD_DIR
from sgc_tpu_torch.utils.device import resolve_device

PROBE_CELLS = (64, 1024)            # cells streamed by the matmul probe
PROBE_EDGES = (200_000, 1_600_000)  # edges of the sparse-path probe
PROBE_F = 256                       # feature width of the cell probe

_RATES: dict[str, dict] = {}


def _cache_path(device: torch.device):
    name = torch.cuda.get_device_name(device).replace(" ", "_")
    return BUILD_DIR / f"rates-{name}.json"


def _best_ms(fn, reps: int = 5) -> float:
    """Least CUDA-event time of ``reps`` calls of ``fn`` (warmed)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _probe_blockdense_eff_flops(device, row_block: int = 512,
                                stripe: int = 512) -> float:
    """Effective flop rate of the cell path (kernel A) at the main path's
    precision, ``"f32"``, differenced over two cell counts."""
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.ops.spmm_blockdense import (
        blockdense_device_args,
        spmm_blockdense,
        split_block_dense,
    )

    rng = np.random.default_rng(0)
    f_pad = -(-PROBE_F // 128) * 128
    times, flops = [], []
    for n_cells in PROBE_CELLS:
        n_rb = 8
        n = max(n_rb, -(-n_cells // n_rb)) * row_block
        n_grid = n // row_block
        ci = rng.integers(0, n_grid, n_cells)
        cj = rng.integers(0, n_grid, n_cells)
        rows = (ci[:, None] * row_block
                + rng.integers(0, row_block, (n_cells, 64))).ravel()
        cols = (cj[:, None] * stripe
                + rng.integers(0, stripe, (n_cells, 64))).ravel()
        vals = rng.random(rows.size).astype(np.float32)
        g = SparseGraph.from_coo(rows, cols, vals, n, n)
        split = split_block_dense(g, PROBE_F, row_block, stripe, min_edges=0)
        args = blockdense_device_args(split, device)
        x = torch.from_numpy(
            rng.random((n, PROBE_F)).astype(np.float32)).to(device)
        times.append(_best_ms(
            lambda: spmm_blockdense(split, x, args, precision="f32")))
        flops.append(2.0 * split.n_cells * row_block * stripe * f_pad)
    dt = (times[1] - times[0]) * 1e-3
    if dt <= 0:
        raise RuntimeError("cell probe sizes not separable")
    return (flops[1] - flops[0]) / dt


def _probe_sparse_edges_per_s(device) -> float:
    """Edge rate of the sparse path (kernel B) at a Reddit-like gather
    table, differenced over two edge counts."""
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.ops.spmm import spmm_segment

    rng = np.random.default_rng(1)
    n = 229_376
    x = torch.from_numpy(
        rng.random((n, 2 * PROBE_F)).astype(np.float32)).to(device)
    times, edges = [], []
    for n_edges in PROBE_EDGES:
        rows = np.sort(rng.integers(0, n, n_edges))
        cols = rng.integers(0, n, n_edges)
        vals = rng.random(n_edges).astype(np.float32)
        g = SparseGraph.from_coo(rows, cols, vals, n, n).to(device)
        times.append(_best_ms(lambda: spmm_segment(g, x)))
        edges.append(g.nnz)
    dt = (times[1] - times[0]) * 1e-3
    if dt <= 0:
        raise RuntimeError("edge probe sizes not separable")
    return (edges[1] - edges[0]) / dt


def measured_rates(device=None) -> dict:
    """``{"blockdense_eff_flops", "xla_edges_per_s", "probed"}`` for
    ``device`` (``None`` -> the CUDA card). Delete the cache file to
    probe again."""
    from sgc_tpu_torch.ops.spmm_blockdense import (
        BLOCKDENSE_EFF_FLOPS,
        XLA_EDGES_PER_S,
    )

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"blockdense_eff_flops": BLOCKDENSE_EFF_FLOPS,
                "xla_edges_per_s": XLA_EDGES_PER_S, "probed": False}
    path = _cache_path(dev)
    key = str(path)
    if key in _RATES:
        return _RATES[key]
    if path.exists():
        _RATES[key] = json.loads(path.read_text())
        return _RATES[key]
    rates = {
        "blockdense_eff_flops": _probe_blockdense_eff_flops(dev),
        "xla_edges_per_s": _probe_sparse_edges_per_s(dev),
        "probed": True,
        "device": torch.cuda.get_device_name(dev),
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rates))
    _RATES[key] = rates
    return rates
