"""Capability check of the CUDA kernels (replaces the reference's
sgc_tpu/ops/spmm_pallas.py::scalar_prefetch_compiles probe).

The check passes when a CUDA device is present, every kernel library
builds, and three tiny cases through the kernels match their plain
PyTorch versions: a block-dense SpMM (kernels A and B, at both
precisions), a hybrid SpMM (kernels C and B) and an SDDMM (kernel D).
It does not return False: it raises with the reason, so a formulation
that needs the kernels never quietly runs without them. The verdict is
cached per process and device.
"""

from __future__ import annotations

import numpy as np
import torch

from sgc_tpu_torch.utils.device import resolve_device

_PASSED: set[int] = set()

# relative to max|plain|: only the f32 summation order differs
TOLERANCE = 1e-5


def hybrid_case():
    """Three 512-row blocks, the middle one empty and the last ragged:
    one dense cell per outer block (3000 edges in 3 chunks of 1024, so
    72 padding slots each), a sparse remainder in the outer blocks and a
    ragged feature count. Returns ``(graph, split, x)`` on the host; the
    SDDMM case is the same graph with ``a = x`` and ``b`` another random
    matrix, so swapped rows and cols would not go unseen."""
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.ops.spmm_hybrid import split_dense_cells

    rng = np.random.default_rng(1)
    n, f, R = 1200, 45, 512
    rows = np.concatenate([rng.integers(0, R, 3000),
                           rng.integers(2 * R, n, 3000),
                           rng.integers(0, R, 300),
                           rng.integers(2 * R, n, 300)])
    cols = np.concatenate([rng.integers(0, R, 3000),
                           rng.integers(2 * R, n, 3000),
                           rng.integers(R, n, 300),
                           rng.integers(0, 2 * R, 300)])
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    graph = SparseGraph.from_coo(rows, cols, vals, n, n)
    split = split_dense_cells(graph, f, R, R, chunk=1024, min_fill=0.5)
    x = rng.standard_normal((n, f)).astype(np.float32)
    return graph, split, torch.from_numpy(x)


def _check(name: str, got: torch.Tensor, want: torch.Tensor, dev) -> None:
    torch.cuda.synchronize(dev)
    err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                1e-30)
    if not err <= TOLERANCE:
        raise RuntimeError(
            f"CUDA kernels ({name}) disagree with the plain version on "
            f"{dev}: max relative error {err:.3e} > {TOLERANCE}")


def require_cuda_kernels(device=None) -> torch.device:
    """Raise unless the kernels build and run right on ``device``
    (``None`` -> the CUDA card). Returns the resolved device."""
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.ops.spmm import (
        sddmm,
        sddmm_plain,
        spmm_segment_plain,
    )
    from sgc_tpu_torch.ops.spmm_blockdense import (
        spmm_block_dense,
        spmm_blockdense,
        split_block_dense,
    )
    from sgc_tpu_torch.ops.spmm_hybrid import (
        hybrid_device_args,
        spmm_hybrid_split,
    )
    from sgc_tpu_torch.ops.spmm_tiled import spmm_tiled_plain

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
    for precision in ("f32", "bf16"):
        _check(f"A + B, {precision}",
               spmm_blockdense(split, x, precision=precision),
               spmm_block_dense(split, x, precision=precision), dev)

    graph, hsplit, x = hybrid_case()
    x = x.to(dev)
    args = hybrid_device_args(hsplit, dev)
    want = spmm_tiled_plain(hsplit.tiled, x)
    want = want + spmm_segment_plain(args.rest, x)
    _check("C + B", spmm_hybrid_split(hsplit, x, args), want, dev)

    g = graph.to(dev)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(dev)
    _check("D", sddmm(g, x, b), sddmm_plain(g, x, b), dev)
    _PASSED.add(index)
    return dev
