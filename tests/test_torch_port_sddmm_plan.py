"""Kernel D's launch plan (``sgc_tpu_torch/ops/spmm.py::sddmm_plan``), on
the CPU: the plan the wrapper hands to ``csrc/sddmm.cu``.

The kernel gives each edge a group of ``lanes`` lanes (a warp holds
``32 / lanes`` groups); lane ``sub`` of a group holds b's vector at
feature ``f0 + (sub + lanes * i) * vec`` in slot ``i`` of the pass at
``f0``, and a's values there in ``vec / a_vec`` loads; a warp takes
``seg`` consecutive edges in batches of ``32 / lanes * unroll``, group
``g`` taking edges ``pb + u * groups + g``; at 32 lanes (the warp one
group) it sums a batch by one transposing butterfly. These tests hold
the plan to
that layout: every feature has exactly one owner, the lanes fit a warp,
one pass covers up to 640 features, the edges in flight stay in their
limits, and the plan depends on F, the precision and the operands'
alignment alone. A model of the kernel's loops (its loads, zero past F,
the butterfly over each group and its stores) computes every plan's
result on small graphs and holds it to the plain version. (The card
tests hold the kernel itself to the plain version, in
tests/test_torch_port_cuda.py.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import spmm as sp

WIDTHS = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 41, 63, 64, 65,
          127, 128, 300, 500, 602, 639, 640, 641, 700, 1300)
ALIGNS = (16, 8, 4)
PRECISIONS = ("f32", "bf16")


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


def covers_once(plan, F):
    held = owners(plan, F)
    width = plan.lanes * plan.nv * plan.vec
    return (sorted(held) == list(range(F))
            and all(len(o) == 1 for o in held.values())
            and (plan.passes - 1) * width < F)   # no pass in vain


@pytest.mark.parametrize("F", WIDTHS)
def test_plan_covers_every_feature_once(F):
    for align in ALIGNS:
        for precision in PRECISIONS:
            plan = sp.sddmm_plan(F, precision, align)
            assert covers_once(plan, F), (F, align, precision, plan)


@pytest.mark.parametrize("F", WIDTHS)
def test_plan_fits_the_warp_and_the_compiled_kernels(F):
    for align in ALIGNS:
        for precision in PRECISIONS:
            plan = sp.sddmm_plan(F, precision, align)
            assert plan.lanes in (1, 2, 4, 8, 16, 32)
            assert plan.nv in sp.SDDMM_NV
            assert plan.nv * plan.vec <= sp.SDDMM_PASS_VALUES
            # a's loads: the widest f32 vector that F and align allow
            assert F % plan.a_vec == 0
            assert plan.a_vec == 1 or align % (4 * plan.a_vec) == 0
            assert not any(F % v == 0 and align % (4 * v) == 0
                           for v in (2, 4) if v > plan.a_vec)
            # b's: a's at f32, one 8-byte load of 4 bf16 values at bf16
            assert plan.vec == (4 if precision == "bf16" else plan.a_vec)
            # lanes: the least power of two covering ceil(F / vec) vectors
            # when a lane holds SDDMM_LANE_BYTES of b, and one load of the
            # group reads SDDMM_SECTOR_BYTES of the row where it has them
            n_vec = -(-F // plan.vec)
            vec_bytes = plan.vec * (2 if precision == "bf16" else 4)
            per_lane = max(1, sp.SDDMM_LANE_BYTES // vec_bytes)
            sector = min(n_vec, max(1, sp.SDDMM_SECTOR_BYTES // vec_bytes))
            assert plan.lanes in (1, 2, 4, 8, 16, 32)
            assert plan.lanes * per_lane >= n_vec or plan.lanes == 32
            assert plan.lanes >= sector or plan.lanes == 32
            assert plan.lanes == 1 or (plan.lanes // 2 * per_lane < n_vec
                                       or plan.lanes // 2 < sector)
            if F <= 640:
                assert plan.passes == 1, plan
            # a warp takes whole batches, at least SDDMM_SEG_EDGES edges
            # (SDDMM_HOLD_SEG_EDGES when it is one lane group)
            batch = 32 // plan.lanes * plan.unroll
            least = (sp.SDDMM_HOLD_SEG_EDGES if plan.lanes == 32
                     else sp.SDDMM_SEG_EDGES)
            assert plan.seg % batch == 0
            assert least <= plan.seg < least + batch
            assert plan.edges_per_cta == sp.SDDMM_WARPS * plan.seg


@pytest.mark.parametrize("precision", PRECISIONS)
def test_plan_keeps_the_in_flight_limits(precision):
    """Each lane group has ``unroll`` edges in flight: enough that a lane
    gathers SDDMM_IN_FLIGHT_BYTES of b a batch, within [U_MIN, U_MAX]; a
    warp that is one group, SDDMM_HOLD_UNROLL (a power of two, for its
    transposing sum)."""
    for F in WIDTHS:
        for align in ALIGNS:
            plan = sp.sddmm_plan(F, precision, align)
            if plan.lanes == 32:
                assert plan.unroll == sp.SDDMM_HOLD_UNROLL in (2, 4, 8)
                continue
            gathered = plan.nv * plan.vec * (2 if precision == "bf16"
                                             else 4)
            assert sp.SDDMM_U_MIN <= plan.unroll <= sp.SDDMM_U_MAX
            assert plan.unroll == max(sp.SDDMM_U_MIN, min(
                sp.SDDMM_U_MAX, sp.SDDMM_IN_FLIGHT_BYTES // gathered))
            if plan.unroll > sp.SDDMM_U_MIN:
                assert plan.unroll * gathered <= sp.SDDMM_IN_FLIGHT_BYTES


@pytest.mark.parametrize("F,precision,align,want", [
    # GAT's heads: layer 1 (F = 8) and layer 2 (F = 41, an odd head's
    # rows 4 bytes off), then the wide callers
    (8, "f32", 16, (4, 4, 2, 1, 4, 1, 256, 1024)),
    (8, "bf16", 16, (4, 4, 2, 1, 8, 1, 256, 1024)),
    (41, "f32", 4, (1, 1, 8, 6, 2, 1, 256, 1024)),
    (41, "f32", 16, (1, 1, 8, 6, 2, 1, 256, 1024)),
    (41, "bf16", 4, (4, 1, 4, 3, 2, 1, 256, 1024)),
    (602, "f32", 16, (2, 2, 32, 10, 4, 1, 64, 256)),
    (602, "bf16", 16, (4, 2, 32, 5, 4, 1, 64, 256)),
    (1300, "f32", 16, (4, 4, 32, 5, 4, 3, 64, 256)),
])
def test_plan_at_the_callers_widths(F, precision, align, want):
    """(vec, a_vec, lanes, nv, unroll, passes, seg, edges_per_cta): the
    plans the GAT backward and the wide callers launch."""
    assert sp.sddmm_plan(F, precision, align).args() == want


def test_plan_overrides_give_the_variants_plans():
    """The A/B tool's variants and the card tests' forced lanes: every
    lanes from 1 to 32, another share of bytes a lane, other edges per
    warp and edges in flight still cover every feature once, and each
    override lands where the variant's constants put it."""
    for F in (1, 8, 41, 602, 700):
        for precision in PRECISIONS:
            for lanes in (1, 2, 4, 8, 16, 32):
                plan = sp.sddmm_plan(F, precision, lanes=lanes)
                assert plan.lanes == lanes
                assert covers_once(plan, F), plan
            base = sp.sddmm_plan(F, precision)
            plan = sp.sddmm_plan(F, precision, lane_bytes=16)
            assert plan.lanes >= base.lanes and covers_once(plan, F)
            plan = sp.sddmm_plan(F, precision, seg_edges=1024,
                                 hold_seg_edges=1024)
            assert plan.seg >= 1024 and plan.seg % (
                32 // plan.lanes * plan.unroll) == 0
            assert covers_once(plan, F)
            plan = sp.sddmm_plan(F, precision, lanes=32, hold_unroll=8)
            assert plan.unroll == 8
    with pytest.raises(ValueError):
        sp.sddmm_plan(0)
    with pytest.raises(ValueError):
        sp.sddmm_plan(8, "fp8")


def _graph(n_rows, n_cols, nnz, seed, hub=None):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    if hub is not None:
        rows[: nnz // 3] = hub
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[:5] = 0.0                       # genuine zero-weight edges
    return SparseGraph.from_coo(rows, cols, vals, n_rows, n_cols).to("cpu")


@pytest.mark.parametrize("F", (1, 8, 41, 602))
def test_plan_depends_on_width_precision_and_alignment_alone(F):
    """The wrapper's plan (sddmm_plan on operand_align of a and b) for
    graphs of any size and edge count, with b at each alignment."""
    for precision in PRECISIONS:
        for offset in (0, 1, 2):
            plans = set()
            for n_rows, n_cols, nnz in ((7, 5, 11), (1000, 300, 5000),
                                        (4097, 4099, 20000)):
                buf = torch.zeros(n_cols * F + offset)
                b = buf[offset:].view(n_cols, F)
                a = torch.zeros(n_rows, F)
                bk, _ = sp._kernel_copy(b, precision)
                plans.add(sp.sddmm_plan(F, precision, sp.operand_align(a, bk)))
            assert len(plans) == 1, plans


def transpose_reduce(v):
    """csrc/sddmm.cu's warp_transpose_reduce on values ``v[N, 32]`` (N per
    lane): transposing rounds over the top lane bits, then a butterfly;
    lane l ends with the sum of value ``l // (32 // N)``."""
    n = v.shape[0]
    lane = np.arange(32)
    half, off = n // 2, 16
    while half >= 1:
        hi = (lane & off) != 0
        nxt = v.copy()
        for t in range(half):
            keep = np.where(hi, v[half + t], v[t])
            send = np.where(hi, v[t], v[half + t])
            nxt[t] = keep + send[lane ^ off]
        v, half, off = nxt.astype(np.float32), half // 2, off // 2
    x = v[0]
    off = 16 // n
    while off >= 1:
        x, off = (x + x[lane ^ off]).astype(np.float32), off // 2
    return x


def kernel_model(plan, graph, a, b, precision):
    """Kernel D's loops in numpy: each warp's segment, pass, batch, group
    and lane as csrc/sddmm.cu walks them, its zero-filled loads past F,
    each lane's sum in the kernel's order, the xor
    butterfly over each group (at 32 lanes the batch's transposing
    butterfly) and the store. Returns the output and how many times each
    edge was stored in the first pass."""
    bf16 = precision == "bf16"
    F = a.shape[1]
    bk, ld = sp._kernel_copy(b, precision)
    av = (sp.bf16_round(a) if bf16 else a).numpy()
    bv = bk.float().numpy()
    rows, cols = graph.rows.numpy(), graph.cols.numpy()
    nnz, lanes = graph.nnz, plan.lanes
    groups, U = 32 // lanes, plan.unroll
    vec, a_vec, nv = plan.vec, plan.a_vec, plan.nv
    out = np.full(graph.n_edges_padded, np.nan, np.float32)
    out[nnz:] = 0.0                      # the entry's memset
    stored = np.zeros(nnz, np.int64)
    subs = np.arange(lanes)

    def lane_sums(e, p1, f0):
        """Each lane's part of edge e's value in the pass at f0."""
        r, c = rows[min(e, p1 - 1)], cols[min(e, p1 - 1)]
        s = np.zeros(lanes, np.float32)
        for i in range(nv):
            f = f0 + (subs + lanes * i) * vec
            b_in = f < F                 # b's vector loaded, else zeros
            for k in range(vec // a_vec):
                a_in = f + k * a_vec < F     # a's load made, else zeros
                for v in range(a_vec):
                    fv = f + k * a_vec + v
                    x = np.where(a_in, av[r, np.minimum(fv, F - 1)], 0)
                    y = np.where(b_in, bv[c, np.minimum(fv, ld - 1)], 0)
                    s = (x * y + s).astype(np.float32)
        return s

    def store(e, p1, f0, v):
        if e < p1:
            out[e] = v if f0 == 0 else out[e] + v
            stored[e] += f0 == 0

    for p0 in range(0, nnz, plan.seg):
        p1 = min(p0 + plan.seg, nnz)
        for f0 in range(0, F, lanes * nv * vec):
            for pb in range(p0, p1, groups * U):
                if lanes == 32:
                    sums = transpose_reduce(np.stack(
                        [lane_sums(pb + u, p1, f0) for u in range(U)]))
                    for u in range(U):
                        store(pb + u, p1, f0, sums[u * (32 // U)])
                    continue
                for g in range(groups):
                    for u in range(U):
                        s = lane_sums(pb + u * groups + g, p1, f0)
                        off = lanes // 2
                        while off:
                            s = (s + s[subs ^ off]).astype(np.float32)
                            off //= 2
                        assert np.all(s == s[0])  # every lane holds the sum
                        store(pb + u * groups + g, p1, f0, s[0])
    return out, stored


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("F", (1, 3, 8, 9, 41, 64, 602, 700))
def test_kernel_model_matches_plain_for_every_lanes(F, precision):
    """Every plan, by the kernel's loops, on a graph with a hub row, short
    rows and a segment cut mid-batch: each edge stored once, padding 0,
    zero-weight edges kept, and the plain version's values (1e-5 of
    max|plain|; only the sum order differs). An edge order out of row
    order gives the same values."""
    g = _graph(23, 19, 61 if F >= 602 else 301, seed=F, hub=4)
    gen = torch.Generator().manual_seed(F)
    a = torch.randn(g.n_rows, F, generator=gen)
    b = torch.randn(g.n_cols, F, generator=gen)
    want = sp.sddmm_plain(g, a, b, precision).numpy()
    scale = float(np.abs(want).max())
    zero_w = np.flatnonzero(g.vals[: g.nnz].numpy() == 0)
    assert len(zero_w)
    lanes_all = (None, 1, 32) if F >= 602 else (None, 1, 2, 4, 8, 16, 32)
    for lanes in lanes_all:
        plan = sp.sddmm_plan(F, precision, lanes=lanes, seg_edges=40,
                             hold_seg_edges=40)
        got, stored = kernel_model(plan, g, a, b, precision)
        assert np.all(stored == 1), plan
        assert np.all(got[g.nnz:] == 0)
        assert np.all(got[zero_w] != 0)  # the zero-weight edges
        assert np.abs(got - want).max() <= 1e-5 * scale, plan
    perm = np.random.default_rng(F).permutation(g.nnz)
    order = np.concatenate([perm, np.arange(g.nnz, g.n_edges_padded)])
    shuffled = dataclasses.replace(g, rows=g.rows[order], cols=g.cols[order],
                                   vals=g.vals[order])
    got, _ = kernel_model(sp.sddmm_plan(F, precision, seg_edges=40,
                                        hold_seg_edges=40),
                          shuffled, a, b, precision)
    assert np.abs(got - want[order]).max() <= 1e-5 * scale
