"""Capability check of the CUDA kernels (replaces the reference's
sgc_tpu/ops/spmm_pallas.py::scalar_prefetch_compiles probe).

The check passes when a CUDA device is present, both kernel libraries
build, and a tiny block-dense SpMM through the kernels matches its plain
PyTorch version. It does not return False: it raises with the reason, so
``formulation="auto"`` never quietly picks the plain form on a card. The
verdict is cached per process and device.
"""

from __future__ import annotations

import numpy as np
import torch

from sgc_tpu_torch.utils.device import resolve_device

_PASSED: set[int] = set()

# relative to max|plain|: only the f32 summation order differs
TOLERANCE = 1e-5


def require_cuda_kernels(device=None) -> torch.device:
    """Raise unless the kernels build and run right on ``device``
    (``None`` -> the CUDA card). Returns the resolved device."""
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.ops.spmm_blockdense import (
        spmm_block_dense,
        spmm_blockdense,
        split_block_dense,
    )

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA kernels need a CUDA device, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index in _PASSED:
        return dev
    # two row blocks (the second ragged), one dense diagonal cell, a
    # sparse remainder and a ragged feature count
    rng = np.random.default_rng(0)
    n, f = 700, 37
    dense_r = rng.integers(0, 512, 3000)
    dense_c = rng.integers(0, 512, 3000)
    sparse_r = rng.integers(0, n, 400)
    sparse_c = rng.integers(0, n, 400)
    rows = np.concatenate([dense_r, sparse_r])
    cols = np.concatenate([dense_c, sparse_c])
    vals = rng.random(len(rows)).astype(np.float32)
    graph = SparseGraph.from_coo(rows, cols, vals, n, n)
    split = split_block_dense(graph, f, min_edges=1000)
    if not (split.n_cells and split.rest is not None):
        raise AssertionError("capability case must exercise both kernels")
    x = torch.from_numpy(
        rng.standard_normal((n, f)).astype(np.float32)).to(dev)
    got = spmm_blockdense(split, x)
    want = spmm_block_dense(split, x)
    torch.cuda.synchronize(dev)
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if not err <= TOLERANCE:
        raise RuntimeError(
            f"CUDA kernels disagree with the plain version on {dev}: "
            f"max relative error {err:.3e} > {TOLERANCE}")
    _PASSED.add(index)
    return dev
