"""SpMM and SDDMM over the row-sorted graph (the counterpart of
sgc_tpu/ops/spmm.py).

``spmm_segment`` is kernel B of the port (``csrc/spmm_csr.cu``): a
deterministic CSR SpMM that can also add a dense term in its epilogue
(the block-dense and hybrid ops' ``dense + rest``); ``ops/spmm_tiled.py``
launches the same CUDA kernel as kernel C. Both launch it through
:func:`launch_csr`, with the plan of :func:`csr_plan` (vector width,
lanes per row, vectors per lane, edges in flight, passes, rows per CTA),
which depends on F, the precision and the operands' alignment alone;
kernel B launches the CTAs that hold hub rows first (:func:`cta_order`,
built at a graph's second launch, kept per graph and plan), and where x
outgrows the card's L2 on a prepared operator it walks the rows in the
order the operator carries (:func:`row_walk`: ``graph.walk``, decided
and built once by ops/autograd.py::prepare_operator from
graph/reorder.py::walk_order); neither changes a bit of the result. On
a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`spmm_segment_plain`, the plain PyTorch version, a sequential
``index_add_`` in sorted edge order.

``spmm`` is the dispatcher. Its impls are ``auto``, ``segment``,
``chunked``, ``tiled`` (the reference's ``"pallas"``, renamed because the
port's kernel C is not Pallas), ``hybrid`` and ``blockdense``.

``sddmm`` is kernel D (``csrc/sddmm.cu``) on a CUDA tensor and
:func:`sddmm_plain` on a CPU tensor. Kernel D walks the graph's own
row-sorted edge list, so it needs no host build; it launches with the
plan of :func:`sddmm_plan` (vector width, lanes per edge, vectors per
lane, edges in flight, passes, edges per warp and CTA), which depends on
F, the precision and the operands' alignment alone.

``precision`` is the reference's (``"f32"`` or ``"bf16"``, default
``"f32"``) wherever it takes one: ``"bf16"`` rounds the gathered operand
rows to bf16 and keeps products and sums in f32 (:func:`bf16_round`).

Determinism is a property of the ops, as in the reference: the kernels
sum in a fixed order with no float atomics, so repeated runs give
identical bits; ``segment`` and ``chunked`` agree bit for bit.

Gradients: ``spmm`` under ``auto``, ``segment`` and ``chunked`` goes
through ``ops/autograd.py::SpmmSegmentFn`` (kernels B and D in the
backward) whenever x, the graph's values or the dense operand need a
gradient; ``tiled``,
``hybrid`` and ``blockdense`` raise there, as the reference cannot
differentiate its ``pallas_call``s either. ``spmm_segment`` and ``sddmm``
are the kernels themselves and raise on such inputs rather than return
a result with no gradient.
"""

from __future__ import annotations

import dataclasses

import torch

from sgc_tpu_torch.graph.sparse import RowWalk, SparseGraph
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.utils.buildcache import HostBuildCache
from sgc_tpu_torch.utils.profiling import count

# launches are counted in utils/profiling.py's registry: the CUDA kernel
# behind spmm_segment (kernel B) as launch.csr_spmm, that behind sddmm
# (kernel D, each after a memset of the padding slots) as launch.sddmm,
# and those of its launches whose plan gives an edge fewer than 32 lanes
# (several edges a warp) also as within.sddmm.shared_warp; kernel B's
# launches that add a dense operand also as within.csr_spmm_dense, and
# those that walk a prepared operator's rows (row_walk) as
# within.csr_spmm_ordered

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
# A CTA whose busiest warp walks more than this many times the mean
# warp's edges is launched before the others (heavy_first)
CSR_HEAVY_WARP = 4.0


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


# Kernel D's launch plan; these mirror csrc/sddmm.cu's constants, and the
# kernel refuses a plan it does not compile.
SDDMM_WARPS = 4             # warps per CTA
SDDMM_LANE_BYTES = 32       # b bytes a lane holds per pass, at least,
SDDMM_SECTOR_BYTES = 32     # and bytes of a row one load of a group reads
SDDMM_PASS_VALUES = 20      # b values a lane holds per pass, at most
SDDMM_NV = (1, 2, 3, 4, 5, 6, 10, 20)   # vectors per lane it compiles
SDDMM_IN_FLIGHT_BYTES = 64  # b bytes a lane gathers per batch of edges
SDDMM_U_MIN, SDDMM_U_MAX = 2, 8   # edges per batch and lane group
SDDMM_SEG_EDGES = 256       # edges per warp, at least (whole batches)
# a warp that is one lane group (32 lanes an edge): edges per batch, and
# edges per warp at least
SDDMM_HOLD_UNROLL, SDDMM_HOLD_SEG_EDGES = 4, 64


@dataclasses.dataclass(frozen=True)
class SddmmPlan:
    """One launch of kernel D: each edge gets ``lanes`` lanes (a warp
    holds ``32 // lanes`` lane groups, each on its own edge); a lane loads
    ``vec`` elements of b (``a_vec`` f32 values of a) at a time and holds
    ``nv`` such vectors of its edge's features per pass, so a pass covers
    ``lanes * nv * vec`` features; each group has ``unroll`` edges in
    flight, gathered before any is summed; a warp takes ``seg``
    consecutive edges (whole batches of ``32 // lanes * unroll``) and a
    CTA ``edges_per_cta``. At 32 lanes (the warp one group) the kernel
    holds a's row per run of equal rows; narrower groups read it once an
    edge."""

    vec: int
    a_vec: int
    lanes: int
    nv: int
    unroll: int
    passes: int
    seg: int
    edges_per_cta: int

    def args(self) -> tuple[int, ...]:
        """The plan as the C entry takes it, after ``bf16``."""
        return (self.vec, self.a_vec, self.lanes, self.nv, self.unroll,
                self.passes, self.seg, self.edges_per_cta)


def sddmm_plan(F: int, precision: str = "f32", align: int = 16, *,
               lanes: int | None = None, lane_bytes: int = SDDMM_LANE_BYTES,
               seg_edges: int = SDDMM_SEG_EDGES,
               hold_unroll: int = SDDMM_HOLD_UNROLL,
               hold_seg_edges: int = SDDMM_HOLD_SEG_EDGES) -> SddmmPlan:
    """Kernel D's plan at width ``F`` and ``precision``, when a and b
    (at ``"bf16"``: a and the kernel's bf16 copy of b) start at a multiple
    of ``align`` bytes. ``a_vec`` is the widest of 4, 2, 1 f32 values that
    divides F and that ``align`` allows; ``vec`` is ``a_vec`` at
    ``"f32"`` (a and b are loaded alike) and 4 at ``"bf16"`` (one 8-byte
    load of the copy, whose rows are zero-padded to a multiple of 4);
    ``lanes`` the least power of two covering the ``ceil(F / vec)``
    vectors when a lane holds ``lane_bytes`` of them (two 16-byte vectors,
    four 8-byte or eight 4-byte ones), but enough that one load of the
    group reads ``SDDMM_SECTOR_BYTES`` of a row where the row has them
    (two lanes of 16-byte vectors), at most 32; ``nv`` the fewest
    compiled vectors per lane that cover the rest, capped so that a pass
    covers up to 640 features. A lane group has ``unroll`` edges in
    flight: enough that a lane gathers ``SDDMM_IN_FLIGHT_BYTES`` of b,
    within ``[SDDMM_U_MIN, SDDMM_U_MAX]``, or ``hold_unroll`` at 32 lanes;
    ``seg`` is the fewest whole batches that reach ``seg_edges``
    (``hold_seg_edges`` at 32 lanes), and a CTA has ``SDDMM_WARPS`` warps.
    The keywords override the defaults for variants of the kernel that
    compile other constants."""
    if F < 1:
        raise ValueError(f"F must be >= 1, got {F}")
    check_precision(precision)
    a_vec = next(v for v in (4, 2, 1)
                 if v == 1 or (F % v == 0 and align % (4 * v) == 0))
    bf16 = precision == "bf16"
    vec = 4 if bf16 else a_vec
    elem = 2 if bf16 else 4
    n_vec = -(-F // vec)
    if lanes is None:
        per_lane = max(1, lane_bytes // (vec * elem))
        sector = min(n_vec, max(1, SDDMM_SECTOR_BYTES // (vec * elem)))
        lanes = min(32, 1 << (max(-(-n_vec // per_lane), sector)
                              - 1).bit_length())
    cap = SDDMM_PASS_VALUES // vec
    need = min(-(-n_vec // lanes), cap)
    nv = min(n for n in SDDMM_NV if need <= n <= cap)
    hold = lanes == 32
    gathered = nv * vec * elem
    unroll = hold_unroll if hold else max(
        SDDMM_U_MIN, min(SDDMM_U_MAX, SDDMM_IN_FLIGHT_BYTES // gathered))
    batch = 32 // lanes * unroll
    seg = -(-(hold_seg_edges if hold else seg_edges) // batch) * batch
    return SddmmPlan(vec=vec, a_vec=a_vec, lanes=lanes, nv=nv,
                     unroll=unroll, passes=-(-n_vec // (lanes * nv)),
                     seg=seg, edges_per_cta=SDDMM_WARPS * seg)


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
               cta_order: torch.Tensor | None = None,
               row_map: torch.Tensor | None = None) -> None:
    """One launch of the CSR kernel into ``out`` ``[n_rows, F]`` (kernel
    B, or kernel C on its re-sorted layout), with the plan of
    :func:`csr_plan` unless ``plan`` is given, its CTAs in the order
    ``cta_order`` gives (:func:`heavy_first`; None: index order); with
    ``row_map`` (int32 ``[n_rows]``, a :class:`RowWalk`'s; f32 x only)
    the CSR's row r is the product's row ``row_map[r]``, read from
    ``dense`` and written to ``out`` there; ``lib`` is another build of the kernel's C
    entry (the A/B tool's variants), default the package's. Raises when
    the launch fails."""
    n_rows, F = out.shape
    if plan is None:
        plan = csr_plan(F, x_bf16, operand_align(x, dense, out))
    rc = (lib or kernels.entry("spmm_csr"))(
        row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
        dense.data_ptr() if dense is not None else None, out.data_ptr(),
        n_rows, F, int(x_bf16), *plan.args(), kernels.stream_of(x),
        cta_order.data_ptr() if cta_order is not None else None,
        row_map.data_ptr() if row_map is not None else None)
    kernels.check_launch(rc, "csr_spmm")


def heavy_first(row_ptr: torch.Tensor, n_rows: int,
                rows_per_cta: int) -> torch.Tensor:
    """Kernel B's CTAs (``rows_per_cta`` consecutive rows each) in the
    order to launch them, int32 on ``row_ptr``'s device: first the CTAs
    whose busiest warp walks more than ``CSR_HEAVY_WARP`` times the mean
    warp's edges, busiest first, then the others in index order. The GPU
    starts CTAs in launch order, so a hub row's walk begun in the last
    wave would set the launch's end; the rest keep the rows' order and
    whatever locality it has. Device operations only: no host sync."""
    dev = row_ptr.device
    rows_per_warp = rows_per_cta // CSR_WARPS
    starts = torch.arange(0, n_rows, rows_per_warp, device=dev)
    ends = (starts + rows_per_warp).clamp_max(n_rows)
    ptr = row_ptr.long()
    work = (ptr[ends] - ptr[starts]).float()
    n_ctas = -(-n_rows // rows_per_cta)
    busiest = torch.nn.functional.pad(
        work, (0, n_ctas * CSR_WARPS - work.numel())).view(
            n_ctas, CSR_WARPS).amax(dim=1)
    key = torch.where(busiest > CSR_HEAVY_WARP * work.mean(), -busiest, 0.0)
    return torch.argsort(key, stable=True).to(torch.int32)


# heavy_first per graph and plan, keyed by the row pointers' identity;
# and the row pointers launched on once so far, apart, so that graphs
# built for one launch do not evict the orders of those launched again
_CTA_ORDERS = HostBuildCache(16)
_LAUNCHED_ONCE = HostBuildCache(16)


def cta_order(graph: SparseGraph, rows_per_cta: int
              ) -> torch.Tensor | None:
    """Kernel B's CTA order for ``graph``: None (index order) at the
    first launch on its row pointers and ``rows_per_cta``;
    :func:`heavy_first`'s from the second on, built then and kept. A
    graph built for one launch (``scatter_graph``'s, as word2vec's
    updates and the embedding gradient build one a step) costs a lookup
    and no device work; one launched again (a fit's hops, a training
    step's layers) pays heavy_first's few small operations once."""
    return _cta_order(graph.row_ptr, graph.n_rows, rows_per_cta)


def _cta_order(row_ptr: torch.Tensor, n_rows: int,
               rows_per_cta: int) -> torch.Tensor | None:
    pins, extra = (row_ptr,), (n_rows, rows_per_cta)
    order = _CTA_ORDERS.find(pins, extra)
    if order is not None:
        return order
    if _LAUNCHED_ONCE.find(pins, extra) is None:
        _LAUNCHED_ONCE.get(pins, extra, lambda: True)
        return None
    return _CTA_ORDERS.get(pins, extra, lambda: heavy_first(
        row_ptr, n_rows, rows_per_cta))


def walk_rows(graph: SparseGraph, row_map: torch.Tensor) -> RowWalk:
    """``graph``'s CSR with its rows in the order ``row_map``
    (``row_map[r]`` the graph's row that comes r-th), each row's edges
    in their ``row_ptr`` order, its values walked with them. Device
    operations on the graph's device, no host sync."""
    n, nnz = graph.n_rows, graph.nnz
    dev = graph.row_ptr.device
    row_map = row_map.to(device=dev, dtype=torch.long)
    ptr = graph.row_ptr.long()
    starts = ptr[row_map]
    deg = ptr[1:][row_map] - starts
    ptr_w = torch.cat((deg.new_zeros(1), torch.cumsum(deg, 0)))
    walked = torch.repeat_interleave(torch.arange(n, device=dev), deg,
                                     output_size=nnz)
    edge_perm = (starts - ptr_w[:-1])[walked] + torch.arange(nnz,
                                                             device=dev)
    return RowWalk(ptr_w.to(torch.int32),
                   graph.cols.index_select(0, edge_perm),
                   graph.vals.index_select(0, edge_perm),
                   row_map.to(torch.int32))


_L2_BYTES: dict = {}


def l2_bytes(device: torch.device) -> int:
    """The L2 cache size of the CUDA ``device`` (a tensor's, so with its
    index), read once."""
    size = _L2_BYTES.get(device)
    if size is None:
        size = _L2_BYTES[device] = int(
            torch.cuda.get_device_properties(device).L2_cache_size)
    return size


def row_walk(graph: SparseGraph, F: int) -> RowWalk | None:
    """The walk kernel B launches for a product of ``graph`` at width
    ``F``, or None (index order): the walk a prepared operator carries
    (``graph.walk``), where the gathered table, ``n_cols x F`` f32,
    outgrows the L2 of the graph's device (:func:`l2_bytes`), so that the
    rows' order decides what stays in it. The graph alone decides: no
    launch before this one does."""
    if graph.walk is None or 4 * graph.n_cols * F <= l2_bytes(
            graph.row_ptr.device):
        return None
    return graph.walk


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

    ``graph`` must live on x's device (:meth:`SparseGraph.to`). On the
    card a prepared operator's rows are walked in its order
    (:func:`row_walk`).
    """
    _check_operand(graph, x)
    _no_grad_operands("spmm_segment", x, graph.vals, dense)
    if x.device.type == "cpu":
        return spmm_segment_plain(graph, x, dense)
    return _spmm_segment_cuda(graph, x, dense)


def _spmm_segment_cuda(graph, x, dense):
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
    plan = csr_plan(F, False, operand_align(x, dense, out))
    walk = row_walk(graph, F)
    if walk is None:
        launch_csr(graph.row_ptr, graph.cols, graph.vals, x, dense, out,
                   plan=plan, cta_order=cta_order(graph, plan.rows_per_cta))
    else:
        launch_csr(walk.row_ptr, walk.cols, walk.vals, x, dense, out,
                   plan=plan, cta_order=_cta_order(
                       walk.row_ptr, graph.n_rows, plan.rows_per_cta),
                   row_map=walk.row_map)
    count("launch.csr_spmm")
    if dense is not None:
        count("within.csr_spmm_dense")
    if walk is not None:
        count("within.csr_spmm_ordered")
    return out


def row_sums(graph: SparseGraph, vals: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum of vals[e]`` over row r's live edges, f32
    ``[n_rows]``: kernel B with F = 1 against a column of ones, each row
    one chain in edge order."""
    ones = torch.ones((graph.n_cols, 1), dtype=torch.float32,
                      device=vals.device)
    return spmm_segment(graph.with_vals(vals.contiguous().float()),
                        ones)[:, 0]


def scatter_graph(ids: torch.Tensor, n_rows: int,
                  value: float = 1.0) -> SparseGraph:
    """The ``[n_rows, len(ids)]`` matrix with ``value`` at ``(ids[j], j)``
    for every j, as a graph on ``ids``' device: rows are ``ids`` stably
    sorted, columns the positions, so each row lists its positions in
    increasing order. ``spmm_segment(scatter_graph(ids, n, v), rows,
    dense=table)`` is ``table`` with ``v * rows[j]`` added into row
    ``ids[j]`` for every j, in the order of j: the scatter-add
    ``table.at[ids].add(v * rows)`` as one launch of kernel B, with no
    float atomics. The sort and the row pointers stay on the device."""
    ids = ids.reshape(-1)
    order = torch.sort(ids, stable=True)
    bounds = torch.arange(n_rows + 1, device=ids.device,
                          dtype=order.values.dtype)
    n = int(ids.shape[0])
    return SparseGraph(
        rows=order.values.to(torch.int32),
        cols=order.indices.to(torch.int32),
        vals=torch.full((n,), value, dtype=torch.float32,
                        device=ids.device),
        row_ptr=torch.searchsorted(order.values, bounds, out_int32=True),
        n_rows=int(n_rows), n_cols=n, nnz=n)


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
         chunk: int = _DEFAULT_CHUNK, *, dense: torch.Tensor | None = None,
         span_name: str = "spmm") -> torch.Tensor:
    """Sparse x dense product, f32 ``[n_rows, F]``, plus ``dense``
    (``[n_rows, F]``, optional) in the same launch of kernel B; by
    ``impl``:

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

    ``dense`` is taken by ``auto`` and ``segment`` alone (kernel B's
    epilogue add); the other impls raise with it.

    When x, ``graph.vals`` or ``dense`` needs a gradient, ``auto``,
    ``segment`` and ``chunked`` run ``SpmmSegmentFn`` (kernel B forward;
    kernel B over the transpose and kernel D backward), recorded under the
    span ``span_name``, and the other impls raise.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown spmm impl {impl!r}; one of {IMPLS}")
    _check_operand(graph, x)
    if dense is not None and impl not in ("auto", "segment"):
        raise ValueError(f"spmm(impl={impl!r}) takes no dense operand; "
                         "use 'auto' or 'segment'")
    if _needs_grad(x, graph.vals, dense):
        if impl not in ("auto", "segment", "chunked"):
            raise ValueError(f"spmm(impl={impl!r}) is not differentiable; "
                             "use 'auto', 'segment' or 'chunked' for "
                             "inputs that need a gradient")
        from sgc_tpu_torch.ops.autograd import SpmmSegmentFn

        return SpmmSegmentFn.apply(graph, graph.vals, x, dense, span_name)
    if dense is not None:
        return spmm_segment(graph, x, dense)
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
                precision: str, lib=None,
                plan: SddmmPlan | None = None) -> torch.Tensor:
    """Kernel D on CUDA operands, with the plan of :func:`sddmm_plan`
    unless ``plan`` is given; ``lib`` is another build of the kernel's C
    entry (the A/B tool's variants), default the package's."""
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
    if plan is None:
        plan = sddmm_plan(F, precision, operand_align(a, bk))
    rc = (lib or kernels.entry("sddmm"))(
        graph.rows.data_ptr(), graph.cols.data_ptr(), a.data_ptr(),
        bk.data_ptr(), out.data_ptr(), graph.nnz, graph.n_edges_padded, F,
        ld, int(precision == "bf16"), *plan.args(), kernels.stream_of(a))
    kernels.check_launch(rc, "sddmm")
    count("launch.sddmm")
    if plan.lanes < 32:
        count("within.sddmm.shared_warp")
    return out
