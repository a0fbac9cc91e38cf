"""The port's ``sddmm`` against the reference's XLA ``sddmm`` and its
Pallas ``sddmm_pallas`` (interpret mode, precision "f32" and "bf16"), and
a numpy emulation of kernel D's walk over the edge list.

On the CPU ``sddmm`` runs its plain version; kernel D itself is tested on
the card in test_torch_port_cuda.py. Tolerance: rtol = atol = 1e-5
relative to max|ref|, since only the f32 summation order over the
features differs (at "bf16" both sides round the same operand rows to
bf16 and sum their products in f32). Padding slots must be exactly 0 on
both sides. The emulation (warp segments of 64 edges, runs of one row
found per 32 edges, passes of 640 features) is held against the plain
version at 1e-5, and must write every edge exactly once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops.spmm import sddmm as ref_sddmm
from sgc_tpu.ops.spmm_pallas import sddmm_pallas as ref_sddmm_pallas

from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.ops import spmm as port_spmm

TOL = 1e-5


def assert_close_rel(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max relative error {err:.3e} > {tol}"


def problem(seed, n_rows, n_cols, e, f, n_zero=0):
    """A random graph (the first ``n_zero`` edges of weight 0) and
    operands, as (reference graph, port graph on the CPU, a, b)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, e)
    cols = rng.integers(0, n_cols, e)
    vals = rng.random(e).astype(np.float32)
    vals[:n_zero] = 0.0
    rg = RefGraph.from_coo(rows, cols, vals, n_rows, n_cols, device=False)
    pg = PortGraph.from_coo(rows, cols, vals, n_rows, n_cols).to("cpu")
    a = rng.standard_normal((n_rows, f)).astype(np.float32)
    b = rng.standard_normal((n_cols, f)).astype(np.float32)
    return rg, pg, a, b


# (n_rows, n_cols, edges, F, reference chunk): square with a chunk that
# divides E_pad; rectangular; a chunk that does not divide E_pad
CASES = {
    "square": (128, 128, 800, 32, 256),
    "rectangular": (48, 80, 300, 16, 1024),
    "nondividing_chunk": (128, 128, 700, 16, 768),
}


# the "f32" cases keep their earlier ids; "bf16" ones add a suffix
REF_CASES = ([(c, "f32") for c in sorted(CASES)]
             + [(c, "bf16") for c in sorted(CASES)])


@pytest.mark.parametrize(
    "case,precision", REF_CASES,
    ids=[c if p == "f32" else f"{c}-bf16" for c, p in REF_CASES])
def test_sddmm_matches_reference(case, precision):
    n_rows, n_cols, e, f, chunk = CASES[case]
    rg, pg, a, b = problem(len(case), n_rows, n_cols, e, f)
    got = port_spmm.sddmm(pg, torch.from_numpy(a), torch.from_numpy(b),
                          precision)
    assert got.shape == (pg.n_edges_padded,) and got.dtype == torch.float32
    pallas = np.asarray(ref_sddmm_pallas(rg, jnp.asarray(a), jnp.asarray(b),
                                         chunk=chunk, interpret=True,
                                         precision=precision))
    assert_close_rel(got.numpy(), pallas)
    assert not got[pg.nnz:].any()           # padding slots exactly 0
    assert not pallas[pg.nnz:].any()
    xla = np.asarray(ref_sddmm(rg, jnp.asarray(a), jnp.asarray(b)))
    assert not xla[pg.nnz:].any()
    if precision == "f32":
        assert_close_rel(got.numpy(), xla)
    else:   # a different function: the operands' bf16 rounding shows
        scale = float(np.abs(xla).max())
        assert float(np.abs(got.numpy() - xla).max()) > 10 * TOL * scale


def test_sddmm_keeps_zero_weight_true_edges():
    """Padding is positional: a genuine edge of weight 0 keeps its
    computed value, so ``with_vals(sddmm(...))`` is closed under repeated
    reweighting, as in the reference."""
    rg, pg, a, b = problem(40, 60, 60, 200, 8, n_zero=20)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = port_spmm.sddmm(pg, at, bt)
    zero_w = np.flatnonzero(pg.vals[: pg.nnz].numpy() == 0)
    assert len(zero_w) >= 20 and (got[zero_w] != 0).all()
    want = np.asarray(ref_sddmm(rg, jnp.asarray(a), jnp.asarray(b)))
    assert_close_rel(got.numpy(), want)
    again = port_spmm.sddmm(pg.with_vals(got), at, bt)
    assert torch.equal(again, got)


def test_sddmm_plain_is_chunked_and_exact(monkeypatch):
    """The plain version's edge chunking bounds memory and changes no
    bit of the result."""
    _, pg, a, b = problem(5, 90, 70, 900, 12)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    whole = port_spmm.sddmm_plain(pg, at, bt)
    monkeypatch.setattr(port_spmm, "SDDMM_PLAIN_EDGES", 100)
    assert torch.equal(port_spmm.sddmm_plain(pg, at, bt), whole)
    r, c = pg.rows[: pg.nnz].long(), pg.cols[: pg.nnz].long()
    assert torch.equal(whole[: pg.nnz], (at[r] * bt[c]).sum(-1))


@pytest.mark.parametrize("a_rows,b_rows,f_b", [(59, 60, 8), (60, 61, 8),
                                               (60, 60, 9)])
def test_sddmm_rejects_mismatched_operands(a_rows, b_rows, f_b):
    _, pg, _, _ = problem(6, 60, 60, 100, 8)
    with pytest.raises(ValueError):
        port_spmm.sddmm(pg, torch.zeros(a_rows, 8), torch.zeros(b_rows, f_b))


def test_sddmm_rejects_unknown_precision():
    _, pg, a, b = problem(6, 60, 60, 100, 8)
    with pytest.raises(ValueError, match="precision"):
        port_spmm.sddmm(pg, torch.from_numpy(a), torch.from_numpy(b), "f16")


# ------------------------------------------------- kernel D's edge walk

SEG, PASS = 64, 640      # csrc/sddmm.cu: edges per warp, features a pass


def kernel_d_walk(rows, cols, a, b, e_pad):
    """A numpy emulation of kernel D: each warp takes SEG consecutive
    edges, 32 at a time; within 32 it finds the runs of one row (the
    first later edge whose row differs ends a run) and loads that row of
    ``a`` once a run, keeping it while a run goes on into the next 32;
    each edge sums its dot product in passes of PASS features, f32
    throughout. Returns the output and the writes per edge."""
    out = np.zeros(e_pad, np.float32)
    writes = np.zeros(e_pad, np.int64)
    F, nnz = a.shape[1], len(rows)
    for f0 in range(0, F, PASS):
        fs = slice(f0, f0 + PASS)
        for p0 in range(0, nnz, SEG):
            p1 = min(p0 + SEG, nnz)
            cur = -1
            for pb in range(p0, p1, 32):
                cnt = min(32, p1 - pb)
                k = 0
                while k < cnt:
                    r = rows[pb + k]
                    later = np.flatnonzero(rows[pb + k + 1:pb + cnt] != r)
                    k_end = k + 1 + int(later[0]) if len(later) else cnt
                    if r != cur:
                        av, cur = a[r, fs], r
                    for e in range(pb + k, pb + k_end):
                        v = (av * b[cols[e], fs]).sum(dtype=np.float32)
                        out[e] = v if f0 == 0 else out[e] + v
                        writes[e] += f0 == 0
                    k = k_end
    return out, writes


# (n_rows, n_cols, edges, hub rows of 150 edges): no edges; short rows,
# several a segment; hubs cut across segments; a rectangular graph
WALK_CASES = {
    "no_edges": (50, 50, 0, 0),
    "short_rows": (300, 300, 700, 0),
    "hubs": (120, 200, 300, 3),
    "rectangular": (90, 400, 500, 1),
}


@pytest.mark.parametrize("f", [45, 33, 1300])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_kernel_d_walk_matches_plain(case, f):
    """Walking the edge list as kernel D does gives the plain SDDMM at
    both precisions (odd F, F under a pass, two passes), every edge
    written once and the padding slots 0; the graph's own order and a
    shuffled one (the kernel needs no row order to be right)."""
    n_rows, n_cols, e, hubs = WALK_CASES[case]
    rng = np.random.default_rng(f + e)
    rows = np.concatenate([rng.integers(0, n_rows, e),
                           np.repeat(rng.integers(0, n_rows, hubs), 150)])
    cols = rng.integers(0, n_cols, len(rows))
    g = PortGraph.from_coo(rows, cols, np.ones(len(rows), np.float32),
                           n_rows, n_cols).to("cpu")
    a = rng.standard_normal((n_rows, f)).astype(np.float32)
    b = rng.standard_normal((n_cols, f)).astype(np.float32)
    r, c = g.rows[: g.nnz].numpy(), g.cols[: g.nnz].numpy()
    perm = rng.permutation(g.nnz)
    for precision in ("f32", "bf16"):
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        want = port_spmm.sddmm_plain(g, at, bt, precision).numpy()
        if precision == "bf16":
            at, bt = port_spmm.bf16_round(at), port_spmm.bf16_round(bt)
        for order in (np.arange(g.nnz), perm):
            got, writes = kernel_d_walk(r[order], c[order], at.numpy(),
                                        bt.numpy(), g.n_edges_padded)
            assert (writes[: g.nnz] == 1).all()
            assert not writes[g.nnz:].any() and not got[g.nnz:].any()
            if g.nnz:
                assert_close_rel(got[: g.nnz], want[order])
            else:
                assert not want.any()


@pytest.mark.parametrize("f", [8, 602, 7])
def test_kernel_d_bf16_copy_pads_rows_with_zeros(f):
    """At "bf16" kernel D reads a bf16 copy of b whose rows are padded
    with zeros to a multiple of 4 elements (8-byte aligned rows); at
    "f32" it reads b itself."""
    b = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (5, f)).astype(np.float32))
    same, ld = port_spmm._kernel_copy(b, "f32")
    assert same is b and ld == f
    copy, ld = port_spmm._kernel_copy(b, "bf16")
    assert ld % 4 == 0 and f <= ld < f + 4
    assert copy.dtype == torch.bfloat16 and tuple(copy.shape) == (5, ld)
    assert torch.equal(copy[:, :f].float(), port_spmm.bf16_round(b))
    assert not copy[:, f:].float().any()
