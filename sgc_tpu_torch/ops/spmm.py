"""SpMM and SDDMM over the row-sorted graph (the counterpart of
sgc_tpu/ops/spmm.py).

``spmm_segment`` is kernel B of the port (``csrc/spmm_csr.cu``): a
deterministic CSR SpMM that can also add a dense term in its epilogue
(the block-dense and hybrid ops' ``dense + rest``); ``ops/spmm_tiled.py``
launches the same CUDA kernel as kernel C. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs
:func:`spmm_segment_plain`, the plain PyTorch version, a sequential
``index_add_`` in sorted edge order.

``spmm`` is the dispatcher. Its impls are ``auto``, ``segment``,
``chunked``, ``tiled`` (the reference's ``"pallas"``, renamed because the
port's kernel C is not Pallas), ``hybrid`` and ``blockdense``.

``sddmm`` is kernel D (``csrc/sddmm.cu``) on a CUDA tensor and
:func:`sddmm_plain` on a CPU tensor. Kernel D walks the graph's own
row-sorted edge list, so it needs no host build.

``precision`` is the reference's (``"f32"`` or ``"bf16"``, default
``"f32"``) wherever it takes one: ``"bf16"`` rounds the gathered operand
rows to bf16 and keeps products and sums in f32 (:func:`bf16_round`).

Determinism is a property of the ops, as in the reference: the kernels
sum in a fixed order with no float atomics, so repeated runs give
identical bits; ``segment`` and ``chunked`` agree bit for bit.
"""

from __future__ import annotations

import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import kernels

# launches of the CUDA kernel behind spmm_segment (kernel B)
LAUNCHES = 0
# launches of the CUDA kernel behind sddmm (kernel D), each after a
# memset of the padding slots
SDDMM_LAUNCHES = 0

PRECISIONS = ("f32", "bf16")

IMPLS = ("auto", "segment", "chunked", "tiled", "hybrid", "blockdense")

# Edge-feature intermediates above this many elements make ``auto`` pick
# the chunked impl on the CPU (elements, not bytes: 256M f32 = 1 GiB).
_SEGMENT_ELEM_BUDGET = 256 * 1024 * 1024

# Edges per step of the chunked impl.
_DEFAULT_CHUNK = 512 * 1024

# Edges per step of the plain SDDMM: bounds its two (edges, F) gathers.
SDDMM_PLAIN_EDGES = 1 << 20


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of "
                         f"{PRECISIONS}")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even) and widened back to f32: what
    the reference's bf16 one-hot matmuls select."""
    return x.to(torch.bfloat16).float()


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


def _check_operand(graph: SparseGraph, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != graph.n_cols:
        raise ValueError(f"x must be [{graph.n_cols}, F], got "
                         f"{tuple(x.shape)}")
    if graph.device != x.device:
        raise ValueError(f"graph on {graph.device}, x on {x.device}")


def spmm_segment(graph: SparseGraph, x: torch.Tensor,
                 dense: torch.Tensor | None = None) -> torch.Tensor:
    """``out[r] = dense[r] + sum_{e: rows[e]==r} vals[e] * x[cols[e]]``
    (``dense`` optional), f32 ``[n_rows, F]``.

    ``graph`` must live on x's device (:meth:`SparseGraph.to`).
    """
    _check_operand(graph, x)
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
        graph.n_rows, F, 0, kernels.stream_of(x))
    kernels.check_launch(rc, "csr_spmm")
    LAUNCHES += 1
    return out


def spmm_chunked(graph: SparseGraph, x: torch.Tensor,
                 chunk: int = _DEFAULT_CHUNK) -> torch.Tensor:
    """Memory-bounded SpMM, f32 ``[n_rows, F]``.

    On the CPU: a sequential loop over ``chunk``-edge slices of the
    sorted edges, each gathered, scaled and ``index_add_``-ed into the
    output, so no ``(E, F)`` intermediate exists; the per-row order is
    the sorted edge order, so the result equals :func:`spmm_segment`'s
    bit for bit. On CUDA it is kernel B (:func:`spmm_segment`), which
    never materialises that intermediate either.
    """
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if x.device.type != "cpu":
        return spmm_segment(graph, x)
    _check_operand(graph, x)
    out = torch.zeros((graph.n_rows, x.shape[1]), dtype=torch.float32)
    for s in range(0, graph.nnz, chunk):
        e = slice(s, min(s + chunk, graph.nnz))
        out.index_add_(0, graph.rows[e].long(),
                       x[graph.cols[e].long()] * graph.vals[e, None])
    return out


def spmm(graph: SparseGraph, x: torch.Tensor, impl: str = "auto",
         chunk: int = _DEFAULT_CHUNK) -> torch.Tensor:
    """Sparse x dense product, f32 ``[n_rows, F]``, by ``impl``:

    * ``auto``: ``segment`` on CUDA; on the CPU ``chunked`` when the
      ``(E, F)`` intermediate would exceed ``_SEGMENT_ELEM_BUDGET``
      elements, else ``segment`` (the reference's CPU rule);
    * ``segment``: kernel B; ``chunked``: :func:`spmm_chunked`;
    * ``tiled``: the counterpart of the reference's ``"pallas"`` (kernel
      C over a cached tiling, ops/spmm_tiled.py::spmm_tiled);
    * ``hybrid``: kernel C on the dense cells + kernel B
      (ops/spmm_hybrid.py::spmm_hybrid);
    * ``blockdense``: bf16 cells through kernel A + kernel B
      (ops/spmm_blockdense.py::spmm_blockdense_graph) at the reference's
      default ``precision="bf16"`` (x rounded to bf16 in the dense term);
      it agrees with the reference to f32 rounding, and with the f32
      product to the bf16 rounding of the cells and of x.

    ``tiled``, ``hybrid`` and ``blockdense`` build their host layout and
    place it on x's device on first use, cached by the graph's arrays
    (``utils.buildcache.placed``; ``clear_placed()`` frees the device
    memory). ``graph`` must live on x's device (:meth:`SparseGraph.to`).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown spmm impl {impl!r}; one of {IMPLS}")
    _check_operand(graph, x)
    if impl == "auto":
        if x.device.type == "cpu" and (
                graph.n_edges_padded * x.shape[1] > _SEGMENT_ELEM_BUDGET):
            impl = "chunked"
        else:
            impl = "segment"
    if impl == "segment":
        return spmm_segment(graph, x)
    if impl == "chunked":
        return spmm_chunked(graph, x, chunk=chunk)
    if impl == "tiled":
        from sgc_tpu_torch.ops.spmm_tiled import spmm_tiled

        return spmm_tiled(graph, x)
    if impl == "hybrid":
        from sgc_tpu_torch.ops.spmm_hybrid import spmm_hybrid

        return spmm_hybrid(graph, x)
    from sgc_tpu_torch.ops.spmm_blockdense import spmm_blockdense_graph

    return spmm_blockdense_graph(graph, x)


def sddmm_plain(graph: SparseGraph, a: torch.Tensor, b: torch.Tensor,
                precision: str = "f32") -> torch.Tensor:
    """:func:`sddmm` in plain PyTorch: gathered rows (rounded to bf16 at
    ``"bf16"``) multiplied and summed over the features in f32,
    ``SDDMM_PLAIN_EDGES`` edges at a time."""
    _check_sddmm(graph, a, b)
    check_precision(precision)
    out = torch.zeros(graph.n_edges_padded, dtype=torch.float32,
                      device=a.device)
    for s in range(0, graph.nnz, SDDMM_PLAIN_EDGES):
        e = slice(s, min(s + SDDMM_PLAIN_EDGES, graph.nnz))
        ar, br = a[graph.rows[e].long()], b[graph.cols[e].long()]
        if precision == "bf16":
            ar, br = bf16_round(ar), bf16_round(br)
        out[e] = (ar * br).sum(-1)
    return out


def _check_sddmm(graph: SparseGraph, a: torch.Tensor,
                 b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a and b must be [n, F] with one F, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] != graph.n_rows or b.shape[0] != graph.n_cols:
        raise ValueError(f"a must have {graph.n_rows} rows and b "
                         f"{graph.n_cols}, got {a.shape[0]} and "
                         f"{b.shape[0]}")
    if not graph.device == a.device == b.device:
        raise ValueError(f"graph on {graph.device}, a on {a.device}, b on "
                         f"{b.device}")


def sddmm(graph: SparseGraph, a: torch.Tensor, b: torch.Tensor,
          precision: str = "f32") -> torch.Tensor:
    """Sampled dense-dense matmul: the edge values of ``a @ b.T`` at the
    graph's pattern, f32 ``[E_pad]``; ``out[e] = <a[rows[e]],
    b[cols[e]]>``, on bf16-rounded rows at ``precision="bf16"``.

    The counterpart of both the reference's XLA ``sddmm``
    (sgc_tpu/ops/spmm.py) and ``sddmm_pallas`` (sgc_tpu/ops/spmm_pallas.py).
    Padding slots ``[nnz, E_pad)`` are exactly 0, decided by position, so
    a genuine edge of weight 0 keeps its computed value and
    ``graph.with_vals(sddmm(...))`` stays closed under reweighting. The
    reference's ``chunk`` only shaped its TPU grid; the port has none.
    ``graph`` must live on the operands' device (:meth:`SparseGraph.to`).
    """
    _check_sddmm(graph, a, b)
    check_precision(precision)
    if a.device.type == "cpu":
        return sddmm_plain(graph, a, b, precision)
    return _sddmm_cuda(graph, a, b, precision)


def _kernel_copy(t: torch.Tensor, precision: str) -> tuple[torch.Tensor,
                                                             int]:
    """Kernel D's ``b`` operand and its row stride: t itself at
    ``"f32"``; at ``"bf16"`` a bf16 copy whose rows are padded with zeros
    to a multiple of 4 elements, so that every row starts 8-byte aligned
    for the kernel's 8-byte loads."""
    if precision == "f32":
        return t, int(t.shape[1])
    n, F = t.shape
    ld = -(-F // 4) * 4
    if ld == F:
        return t.to(torch.bfloat16), ld
    out = torch.empty((n, ld), dtype=torch.bfloat16, device=t.device)
    out[:, :F] = t
    out[:, F:] = 0
    return out, ld


def _sddmm_cuda(graph: SparseGraph, a: torch.Tensor, b: torch.Tensor,
                precision: str, lib=None) -> torch.Tensor:
    """Kernel D on CUDA operands; ``lib`` is another build of the kernel's
    C entry (the A/B tool's variants), default the package's."""
    global SDDMM_LAUNCHES
    kernels.require_cuda_f32(a, "a")
    kernels.require_cuda_f32(b, "b")
    for name, t in (("rows", graph.rows), ("cols", graph.cols)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"graph.{name} must be contiguous int32")
    out = torch.empty(graph.n_edges_padded, dtype=torch.float32,
                      device=a.device)
    F = int(a.shape[1])
    if F == 0:
        return out.zero_()
    # the kernel rounds a's rows to bf16 itself; only b is copied
    bk, ld = _kernel_copy(b, precision)
    rc = (lib or kernels.entry("sddmm"))(
        graph.rows.data_ptr(), graph.cols.data_ptr(), a.data_ptr(),
        bk.data_ptr(), out.data_ptr(), graph.nnz, graph.n_edges_padded, F,
        ld, int(precision == "bf16"), kernels.stream_of(a))
    kernels.check_launch(rc, "sddmm")
    SDDMM_LAUNCHES += 1
    return out
