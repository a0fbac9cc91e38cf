"""SpMM over the row-sorted graph (the counterpart of sgc_tpu/ops/spmm.py).

``spmm_segment`` is kernel B of the port (``csrc/spmm_csr.cu``): a
deterministic CSR SpMM that can also add a dense term in its epilogue
(the block-dense op's ``dense + rest``). On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs :func:`spmm_segment_plain`, the
plain PyTorch version, a sequential ``index_add_`` in sorted edge order.

Determinism is a property of the op, as in the reference: the kernel sums
each row's edges in their sorted order with no atomics, so repeated runs
give identical bits. The ``chunked``, ``pallas``/hybrid formulations and
the ``spmm`` dispatcher wait for a later slice of the port.
"""

from __future__ import annotations

import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import kernels

# launches of the CUDA kernel behind spmm_segment (kernel B)
LAUNCHES = 0


def spmm_segment_plain(graph: SparseGraph, x: torch.Tensor,
                       dense: torch.Tensor | None = None) -> torch.Tensor:
    """``dense + A @ x`` in plain PyTorch: gather, scale, and an
    ``index_add_`` over the first ``nnz`` (sorted) edges."""
    nnz = graph.nnz
    rows = graph.rows[:nnz].long()
    cols = graph.cols[:nnz].long()
    vals = graph.vals[:nnz]
    out = torch.zeros((graph.n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, rows, x[cols] * vals[:, None])
    return out if dense is None else dense + out


def spmm_segment(graph: SparseGraph, x: torch.Tensor,
                 dense: torch.Tensor | None = None) -> torch.Tensor:
    """``out[r] = dense[r] + sum_{e: rows[e]==r} vals[e] * x[cols[e]]``
    (``dense`` optional), f32 ``[n_rows, F]``.

    ``graph`` must live on x's device (:meth:`SparseGraph.to`).
    """
    if x.dim() != 2 or x.shape[0] != graph.n_cols:
        raise ValueError(f"x must be [{graph.n_cols}, F], got "
                         f"{tuple(x.shape)}")
    if graph.device != x.device:
        raise ValueError(f"graph on {graph.device}, x on {x.device}")
    if x.device.type == "cpu":
        return spmm_segment_plain(graph, x, dense)
    return _spmm_segment_cuda(graph, x, dense)


def _spmm_segment_cuda(graph, x, dense):
    global LAUNCHES
    F = int(x.shape[1])
    kernels.require_cuda_f32(x, "x")
    if dense is not None:
        kernels.require_cuda_f32(dense, "dense", (graph.n_rows, F))
    for name, t, dt in (("row_ptr", graph.row_ptr, torch.int32),
                        ("cols", graph.cols, torch.int32),
                        ("vals", graph.vals, torch.float32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"graph.{name} must be contiguous {dt}")
    out = torch.empty((graph.n_rows, F), dtype=torch.float32,
                      device=x.device)
    if graph.n_rows == 0 or F == 0:
        return out
    rc = kernels.entry("spmm_csr")(
        graph.row_ptr.data_ptr(), graph.cols.data_ptr(),
        graph.vals.data_ptr(), x.data_ptr(),
        dense.data_ptr() if dense is not None else None, out.data_ptr(),
        graph.n_rows, F, kernels.stream_of(x))
    kernels.check_launch(rc, "csr_spmm")
    LAUNCHES += 1
    return out
