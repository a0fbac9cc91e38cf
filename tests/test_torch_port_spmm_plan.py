"""Kernel B's launch plan (``sgc_tpu_torch/ops/spmm.py::csr_plan``), on
the CPU: the plan the wrapper hands to ``csrc/spmm_csr.cu``.

The kernel holds feature ``f0 + (sub + lanes * i) * vec + v`` of a row in
lane ``sub`` of the row's group, slot ``i`` and vector element ``v``, in
pass ``f0 / (lanes * nv * vec)``; it walks the row's edges in row_ptr
order, in chunks of the warp's staged span and batches of ``unroll``.
These tests hold the plan to that layout: every feature has exactly one
owner, the lanes fit a warp, one pass covers up to 640 features, and the
plan depends on F, the precision and the operands' alignment alone. A
model of the kernel's loops checks that every plan adds a row's edges
once each, in order, for every feature: so the sum order, and the bits,
do not depend on the plan. (The card tests hold the kernel itself to the
same bits across layouts, in tests/test_torch_port_cuda.py.)
"""

import numpy as np
import pytest
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import spmm as sp

WIDTHS = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 41, 63, 64, 65,
          127, 128, 300, 500, 602, 639, 640, 641, 700, 1283)
ALIGNS = (16, 8, 4)
PRECISIONS = (False, True)     # x_bf16


def owners(plan, F):
    """feature -> list of (pass, lane, slot, element) that hold it."""
    width = plan.lanes * plan.nv * plan.vec
    held = {}
    for p in range(plan.passes):
        for sub in range(plan.lanes):
            for i in range(plan.nv):
                for v in range(plan.vec):
                    f = p * width + (sub + plan.lanes * i) * plan.vec + v
                    if f < F:
                        held.setdefault(f, []).append((p, sub, i, v))
    return held


@pytest.mark.parametrize("F", WIDTHS)
def test_plan_covers_every_feature_once(F):
    for align in ALIGNS:
        for x_bf16 in PRECISIONS:
            plan = sp.csr_plan(F, x_bf16, align)
            held = owners(plan, F)
            assert sorted(held) == list(range(F)), (F, align, plan)
            assert all(len(o) == 1 for o in held.values()), (F, plan)
            # the last pass is not empty: no pass walks the edges in vain
            width = plan.lanes * plan.nv * plan.vec
            assert (plan.passes - 1) * width < F


@pytest.mark.parametrize("F", WIDTHS)
def test_plan_fits_the_warp_and_the_compiled_kernels(F):
    for align in ALIGNS:
        for x_bf16 in PRECISIONS:
            plan = sp.csr_plan(F, x_bf16, align)
            assert plan.lanes in (1, 2, 4, 8, 16, 32)
            assert plan.rows_per_cta * plan.lanes == sp.CSR_WARPS * 32
            assert plan.nv in sp.CSR_NV
            assert plan.nv * plan.vec <= sp.CSR_PASS_VALUES
            assert sp.CSR_U_MIN <= plan.unroll <= sp.CSR_U_MAX
            gathered = plan.nv * plan.vec * (2 if x_bf16 else 4)
            assert plan.unroll == max(sp.CSR_U_MIN, min(
                sp.CSR_U_MAX, sp.CSR_IN_FLIGHT_BYTES // gathered))
            # the widest vector that F and the alignment allow
            assert F % plan.vec == 0
            assert plan.vec == 1 or align % (4 * plan.vec) == 0
            wider = [v for v in (2, 4) if v > plan.vec]
            assert not any(F % v == 0 and align % (4 * v) == 0
                           for v in wider)
            # lanes: the least power of two covering F / vec vectors
            n_vec = F // plan.vec
            assert plan.lanes == min(32, 1 << (n_vec - 1).bit_length())
            if F <= 640:
                assert plan.passes == 1, plan


@pytest.mark.parametrize("F,vec,lanes,nv", [
    (1, 1, 1, 1), (8, 4, 2, 1), (16, 4, 4, 1), (41, 1, 32, 2),
    (64, 4, 16, 1), (602, 2, 32, 10)])
def test_plan_at_the_callers_widths(F, vec, lanes, nv):
    """GAT's segment sums and heads, GCN's and deep GCN's widths, and
    Reddit's 602 features: the plan the main path launches."""
    plan = sp.csr_plan(F)
    assert (plan.vec, plan.lanes, plan.nv, plan.passes) == (vec, lanes, nv,
                                                            1)


def test_plan_overrides_keep_the_layout():
    """The A/B tool's variants: other lanes, warps and batch bounds still
    cover every feature once."""
    for F in (8, 41, 602, 700):
        base = sp.csr_plan(F)
        for kw in ({"lanes": max(1, base.lanes // 2)}, {"lanes": 32},
                   {"warps": 4}, {"u_min": 1}, {"u_max": 32}):
            plan = sp.csr_plan(F, **kw)
            held = owners(plan, F)
            assert sorted(held) == list(range(F))
            assert all(len(o) == 1 for o in held.values())
        assert sp.csr_plan(F, warps=4).rows_per_cta * base.lanes == 128
    with pytest.raises(ValueError):
        sp.csr_plan(0)


def test_operand_align():
    buf = torch.zeros(64)
    assert buf.data_ptr() % 16 == 0
    assert sp.operand_align(buf) == 16
    assert sp.operand_align(buf[1:]) == 4
    assert sp.operand_align(buf[2:]) == 8
    assert sp.operand_align(buf[4:], None, buf) == 16
    assert sp.operand_align(buf, buf[2:]) == 8
    half = torch.zeros(64, dtype=torch.bfloat16)
    assert sp.operand_align(half[1:]) == 2


def _graph(n_rows, n_cols, nnz, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return SparseGraph.from_coo(rows, cols, vals, n_rows, n_cols).to("cpu")


@pytest.mark.parametrize("F", (1, 8, 41, 602))
def test_plan_depends_on_width_precision_and_alignment_alone(F):
    """The wrapper's plan (csr_plan on operand_align of x, dense, out) for
    graphs of any size and edge count, with x at each alignment."""
    for x_bf16 in PRECISIONS:
        dtype = torch.bfloat16 if x_bf16 else torch.float32
        for offset in (0, 1, 2):
            plans = set()
            for n_rows, n_cols, nnz in ((7, 5, 11), (1000, 300, 5000),
                                        (4097, 4099, 20000)):
                g = _graph(n_rows, n_cols, nnz, n_rows)
                buf = torch.zeros(n_cols * F + offset, dtype=dtype)
                x = buf[offset:].view(n_cols, F)
                out = torch.empty((g.n_rows, F))
                plans.add(sp.csr_plan(F, x_bf16,
                                      sp.operand_align(x, None, out)))
            assert len(plans) == 1, plans


def walk_order(row_ptr, plan, stage_edges=256):
    """The order in which the kernel adds each row's edges, by its loops:
    each warp's rows ``[r0, r0 + 32 / lanes)`` and their span staged in
    chunks of ``stage_edges`` edges, each row's part of a chunk in
    batches of ``plan.unroll`` (whole batches, then the tail), the same
    edges for every slot and every pass. Returns {row: [edges]}."""
    n_rows = len(row_ptr) - 1
    per_warp = 32 // plan.lanes
    order = {r: [] for r in range(n_rows)}
    for r0 in range(0, n_rows, per_warp):
        last = min(r0 + per_warp, n_rows)
        s0, s1 = row_ptr[r0], row_ptr[last]
        for r in range(r0, last):
            b, e = row_ptr[r], row_ptr[r + 1]
            for c0 in range(s0, s1, stage_edges):
                lo, hi = max(b, c0), min(e, c0 + stage_edges)
                eb = lo
                while eb + plan.unroll <= hi:
                    order[r].extend(range(eb, eb + plan.unroll))
                    eb += plan.unroll
                order[r].extend(range(eb, hi))     # the tail, if any
    return order


@pytest.mark.parametrize("F", (1, 3, 8, 41, 64, 602, 700))
def test_every_plan_adds_each_rows_edges_in_order(F):
    """Degrees 0 (empty rows), 1, below and above a batch, and a hub of
    5,000 edges: for every alignment and precision the plan adds each
    row's edges once each, in row_ptr order."""
    rng = np.random.default_rng(F)
    deg = rng.integers(0, 40, 300)
    deg[::17] = 0
    deg[5] = 5000
    deg[6] = 1
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).tolist()
    for align in ALIGNS:
        for x_bf16 in PRECISIONS:
            plan = sp.csr_plan(F, x_bf16, align)
            for stage_edges in (256, 32):
                order = walk_order(row_ptr, plan, stage_edges)
                for r in range(len(deg)):
                    assert order[r] == list(range(row_ptr[r],
                                                  row_ptr[r + 1])), r
