"""SpMM and SDDMM over the row-sorted graph (the counterpart of
sgc_tpu/ops/spmm.py).

``spmm_segment`` is kernel B of the port (``csrc/spmm_csr.cu``): a
deterministic CSR SpMM that can also add a dense term in its epilogue
(the block-dense and hybrid ops' ``dense + rest``); ``ops/spmm_tiled.py``
launches the same CUDA kernel as kernel C. Both launch it through
:func:`launch_csr`, with the plan of :func:`csr_plan` (vector width,
lanes per row, vectors per lane, edges in flight, passes, rows per CTA),
which depends on F, the precision and the operands' alignment alone. On
a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
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

Gradients: ``spmm`` under ``auto``, ``segment`` and ``chunked`` goes
through ``ops/autograd.py::SpmmSegmentFn`` (kernels B and D in the
backward) whenever x or the graph's values need a gradient; ``tiled``,
``hybrid`` and ``blockdense`` raise there, as the reference cannot
differentiate its ``pallas_call``s either. ``spmm_segment`` and ``sddmm``
are the kernels themselves and raise on such inputs rather than return
a result with no gradient.
"""

from __future__ import annotations

import dataclasses

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

# Edges per step of the plain SpMM and SDDMM: bounds their (edges, F)
# gathers.
SEGMENT_PLAIN_EDGES = 1 << 20
SDDMM_PLAIN_EDGES = 1 << 20

# Kernel B's launch plan; these mirror csrc/spmm_csr.cu's constants, and
# the kernel refuses a plan it does not compile.
CSR_WARPS = 8               # warps per CTA
CSR_PASS_VALUES = 20        # x values a lane holds per pass
CSR_NV = (1, 2, 3, 5, 10, 20)   # vectors per lane the kernel compiles
CSR_IN_FLIGHT_BYTES = 160   # x bytes a lane gathers per batch of edges
CSR_U_MIN, CSR_U_MAX = 2, 16    # edges per batch


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """One launch of kernel B: each row gets ``lanes`` lanes (a warp holds
    ``32 // lanes`` rows); a lane loads ``vec`` values at a time and holds
    ``nv`` such vectors of its row's features per pass, so a pass covers
    ``lanes * nv * vec`` features; it walks its row's edges in batches of
    ``unroll``, gathering a whole batch before it adds any; a CTA takes
    ``rows_per_cta`` consecutive rows."""

    vec: int
    lanes: int
    nv: int
    unroll: int
    passes: int
    rows_per_cta: int

    def args(self) -> tuple[int, ...]:
        """The plan as the C entry takes it, after ``x_bf16``."""
        return (self.vec, self.lanes, self.nv, self.unroll, self.passes,
                self.rows_per_cta)


def csr_plan(F: int, x_bf16: bool = False, align: int = 16, *,
             lanes: int | None = None, warps: int = CSR_WARPS,
             u_min: int = CSR_U_MIN, u_max: int = CSR_U_MAX,
             in_flight: int = CSR_IN_FLIGHT_BYTES) -> CsrPlan:
    """Kernel B's plan at width ``F`` for f32 or bf16 (``x_bf16``) x,
    when x, ``dense`` and ``out`` all start at a multiple of ``align``
    bytes. ``vec`` is the widest of 4, 2, 1 that divides F and whose f32
    vector ``align`` allows; ``lanes`` the least power of two covering F /
    vec vectors, at most 32; ``nv`` the fewest compiled vectors per lane
    that cover the rest, capped so that one pass covers up to 640
    features; ``unroll`` keeps ``CSR_IN_FLIGHT_BYTES`` of x in flight per
    lane, within ``[u_min, u_max]``. ``lanes``, ``warps``, ``u_min``,
    ``u_max`` and ``in_flight`` override the defaults for variants of the
    kernel that compile other constants."""
    if F < 1:
        raise ValueError(f"F must be >= 1, got {F}")
    vec = next(v for v in (4, 2, 1)
               if v == 1 or (F % v == 0 and align % (4 * v) == 0))
    n_vec = F // vec
    if lanes is None:
        lanes = min(32, 1 << (n_vec - 1).bit_length())
    cap = CSR_PASS_VALUES // vec
    need = min(-(-n_vec // lanes), cap)
    nv = min(n for n in CSR_NV if need <= n <= cap)
    gathered = nv * vec * (2 if x_bf16 else 4)
    unroll = max(u_min, min(u_max, in_flight // gathered))
    return CsrPlan(vec=vec, lanes=lanes, nv=nv, unroll=unroll,
                   passes=-(-n_vec // (lanes * nv)),
                   rows_per_cta=warps * 32 // lanes)


def operand_align(*tensors: torch.Tensor | None) -> int:
    """The largest of 16, 8, 4, 2, 1 bytes that divides every given
    tensor's start address (None is skipped)."""
    align = 16
    for t in tensors:
        if t is not None:
            while t.data_ptr() % align:
                align //= 2
    return align


def launch_csr(row_ptr: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, x: torch.Tensor,
               dense: torch.Tensor | None, out: torch.Tensor,
               x_bf16: bool = False, lib=None, plan: CsrPlan | None = None,
               ) -> None:
    """One launch of the CSR kernel into ``out`` ``[n_rows, F]`` (kernel
    B, or kernel C on its re-sorted layout), with the plan of
    :func:`csr_plan` unless ``plan`` is given; ``lib`` is another build of
    the kernel's C entry (the A/B tool's variants), default the
    package's. Raises when the launch fails."""
    n_rows, F = out.shape
    if plan is None:
        plan = csr_plan(F, x_bf16, operand_align(x, dense, out))
    rc = (lib or kernels.entry("spmm_csr"))(
        row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
        dense.data_ptr() if dense is not None else None, out.data_ptr(),
        n_rows, F, int(x_bf16), *plan.args(), kernels.stream_of(x))
    kernels.check_launch(rc, "csr_spmm")


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
    ``index_add_`` over the first ``nnz`` (sorted) edges,
    ``SEGMENT_PLAIN_EDGES`` at a time (in order, so each row sums its
    edges in the same order as in one step)."""
    out = torch.zeros((graph.n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, graph.nnz, SEGMENT_PLAIN_EDGES):
        e = slice(s, min(s + SEGMENT_PLAIN_EDGES, graph.nnz))
        out.index_add_(0, graph.rows[e].long(),
                       x[graph.cols[e].long()] * graph.vals[e, None])
    return out if dense is None else dense + out


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in ts)


def _no_grad_operands(what: str, *ts) -> None:
    if _needs_grad(*ts):
        raise ValueError(f"{what} is not differentiable: use spmm(impl="
                         "'auto' | 'segment' | 'chunked') or the Functions "
                         "of ops/autograd.py for inputs that need a "
                         "gradient")


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
    _no_grad_operands("spmm_segment", x, graph.vals, dense)
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
    launch_csr(graph.row_ptr, graph.cols, graph.vals, x, dense, out)
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

    When x or ``graph.vals`` needs a gradient, ``auto``, ``segment`` and
    ``chunked`` run ``SpmmSegmentFn`` (kernel B forward; kernel B over
    the transpose and kernel D backward) and the other impls raise.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown spmm impl {impl!r}; one of {IMPLS}")
    _check_operand(graph, x)
    if _needs_grad(x, graph.vals):
        if impl not in ("auto", "segment", "chunked"):
            raise ValueError(f"spmm(impl={impl!r}) is not differentiable; "
                             "use 'auto', 'segment' or 'chunked' for "
                             "inputs that need a gradient")
        from sgc_tpu_torch.ops.autograd import SpmmSegmentFn

        return SpmmSegmentFn.apply(graph, graph.vals, x)
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
    _no_grad_operands("sddmm", a, b)
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
