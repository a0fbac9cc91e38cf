"""The one-hot/hybrid slice of the port against the reference.

Both packages get the same numpy inputs. Host layouts (``tile_graph``,
``_flat_schedule``, ``split_dense_cells``) must match bit for bit. The
port's kernel wrappers run their plain versions on the CPU and are held
against the reference's Pallas kernels in interpret mode at precision
"f32" and its XLA ops: rtol = atol = 1e-5 relative to max|ref|, since
only the f32 summation order differs. At precision "bf16" both sides
round the same values to bf16 (x, and each slot's product), so one hop
is held at 1e-5 too; a second hop rounds a slightly different input to
bf16 (``ONEHOT_BF16_K2_TOL``). ``spmm(impl="blockdense")`` runs at the
reference's default ``precision="bf16"`` on both sides (x rounded to
bf16 the same way), so it is held at 1e-5 too.
"""

import dataclasses

import contextlib
import fcntl
import os
import tempfile
import time
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgc_tpu import native as ref_native
from sgc_tpu.data.synthetic import synthetic_reddit_clustered as ref_data
from sgc_tpu.graph.locality import LocalityPlan as RefPlan
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops.spmm import spmm as ref_spmm
from sgc_tpu.ops import spmm_hybrid as ref_hybrid
from sgc_tpu.ops import spmm_pallas as ref_pallas

from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
from sgc_tpu_torch.graph.locality import LocalityPlan
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.ops import spmm as port_spmm
from sgc_tpu_torch.ops import spmm_hybrid as port_hybrid
from sgc_tpu_torch.ops import spmm_tiled as port_tiled
from sgc_tpu_torch.utils.buildcache import clear_placed

TOL = 1e-5
TILED_FIELDS = ("rows", "cols", "vals", "cell_start", "cell_nchunks")


def assert_close_rel(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max relative error {err:.3e} > {tol}"


def coo(seed, n_rows, n_cols, n_edges, dense_cells=(), per_cell=0,
        cell=64, row_hi=None):
    """Uniform edges (rows below ``row_hi``) plus ``per_cell`` edges in
    each of ``dense_cells`` (cell-grid coordinates of size ``cell``)."""
    rng = np.random.default_rng(seed)
    r = [rng.integers(0, row_hi or n_rows, n_edges)]
    c = [rng.integers(0, n_cols, n_edges)]
    for (i, j) in dense_cells:
        r.append(i * cell + rng.integers(0, cell, per_cell))
        c.append(j * cell + rng.integers(0, cell, per_cell))
    rows, cols = np.concatenate(r), np.concatenate(c)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals


def both(rows, cols, vals, n_rows, n_cols):
    return (RefGraph.from_coo(rows, cols, vals, n_rows, n_cols,
                              device=False),
            PortGraph.from_coo(rows, cols, vals, n_rows, n_cols))


def features(seed, n, f):
    return np.random.default_rng(seed).standard_normal(
        (n, f)).astype(np.float32)


def assert_tiled_equal(ref, port):
    for name in TILED_FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(port, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("n_rows", "n_cols", "row_block", "stripe", "chunk"):
        assert getattr(ref, name) == getattr(port, name), name


# (n_rows, n_cols, edges, R, W, C, row_hi): square; rectangular; edges
# in the first row block only (empty cells and row blocks); no edges
TILE_CASES = {
    "square": (300, 300, 2000, 64, 64, 16, None),
    "rectangular": (200, 500, 1800, 128, 96, 32, None),
    "empty_cells": (600, 600, 900, 128, 256, 64, 100),
    "no_edges": (256, 256, 0, 64, 64, 16, None),
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_graph_matches_reference(case):
    n_rows, n_cols, e, R, W, C, row_hi = TILE_CASES[case]
    rg, pg = both(*coo(1, n_rows, n_cols, e, row_hi=row_hi), n_rows, n_cols)
    ref = ref_pallas.tile_graph(rg, row_block=R, stripe=W, chunk=C)
    native = port_tiled.tile_graph(pg, R, W, C)
    plain = port_tiled.tile_graph_plain(pg, R, W, C)
    assert_tiled_equal(ref, native)
    assert_tiled_equal(ref, plain)
    for a, b in zip(ref_pallas._flat_schedule(ref),
                    port_tiled._flat_schedule(native)):
        np.testing.assert_array_equal(a, b)
    # kernel C's two index builders agree
    for a, b in zip(port_tiled.flat_index(native),
                    port_tiled.stripe_index(native)):
        np.testing.assert_array_equal(a, b)
    ptr, chunk_st = port_tiled.flat_index(native)
    assert ptr[-1] == native.n_chunks == len(chunk_st)
    # kernel C's chunk lengths: the edges come first in every chunk, and
    # the slots past them are padding (val 0, the cell's base row)
    np.testing.assert_array_equal(native.cell_nnz, plain.cell_nnz)
    nnz = port_tiled.chunk_nnz(native)
    assert nnz.dtype == np.int32 and nnz.sum() == e
    chunk_rb, _ = port_tiled._flat_schedule(native)
    pad = np.arange(native.chunk)[None, :] >= nnz[:, None]
    assert not native.vals.reshape(-1, native.chunk)[pad].any()
    np.testing.assert_array_equal(
        native.rows.reshape(-1, native.chunk)[pad],
        np.broadcast_to(chunk_rb[:, None] * R, pad.shape)[pad])


# kernel C's row index, (n_rows, n_cols, R, W, C, uniform edges, row_hi,
# dense cells of 64 x 64 with 2,000 edges each): 16-slot chunks under
# dense cells, so rows straddle chunks; edges only in the first row
# block; row blocks taller than 512 rows; stripes wider than 1024
INDEX_CASES = {
    "straddling_rows": (300, 300, 64, 64, 16, 1000, None, ((0, 0), (2, 3))),
    "empty_row_blocks": (600, 600, 128, 256, 64, 900, 100, ()),
    "tall_row_blocks": (2500, 700, 1024, 512, 256, 6000, None, ((20, 3),)),
    "wide_stripes": (700, 3000, 512, 2048, 512, 6000, None, ((1, 40),)),
}


def kernel_c_walk(n_rows, x, row_ptr, cols, vals):
    """A numpy emulation of kernel C: one f32 accumulator per row, its
    edges summed in CSR order."""
    out = np.zeros((n_rows, x.shape[1]), np.float32)
    for r in range(n_rows):
        acc = np.zeros(x.shape[1], np.float32)
        for e in range(row_ptr[r], row_ptr[r + 1]):
            acc += vals[e] * x[cols[e]]
        out[r] = acc
    return out


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_kernel_c_row_index_walk_matches_plain(case):
    """The native row index equals its numpy twin and lists every edge
    slot once (no padding) in (row, layout position) order; the CSR
    gathered through it, walked the way kernel C walks it, gives
    spmm_tiled_plain's product."""
    n_rows, n_cols, R, W, C, e, row_hi, cells = INDEX_CASES[case]
    _, pg = both(*coo(11, n_rows, n_cols, e, cells, 2000, row_hi=row_hi),
                 n_rows, n_cols)
    tiled = port_tiled.tile_graph(pg, R, W, C)
    row_ptr, perm = port_tiled.row_index(tiled)
    plain = port_tiled.row_index_plain(tiled)
    assert row_ptr.dtype == perm.dtype == np.int32
    np.testing.assert_array_equal(row_ptr, plain[0])
    np.testing.assert_array_equal(perm, plain[1])
    nnz = port_tiled.chunk_nnz(tiled)
    assert len(perm) == nnz.sum() == pg.nnz == row_ptr[-1]
    assert (perm % C < nnz[perm // C]).all()          # no padding slot
    r_of = tiled.rows[perm]
    assert (np.diff(r_of) >= 0).all()
    assert (np.diff(perm)[np.diff(r_of) == 0] > 0).all()  # layout order
    if case == "straddling_rows":   # some row's slots span two chunks
        first = np.searchsorted(r_of, r_of, side="left")
        assert (perm // C != perm[first] // C).any()
    if row_hi is not None:
        assert (row_ptr[row_hi:] == row_ptr[-1]).all()   # empty row blocks
    x = features(12, n_cols, 9)
    csr = port_tiled.row_csr(tiled)
    np.testing.assert_array_equal(csr[1], tiled.cols[perm])
    np.testing.assert_array_equal(csr[2], tiled.vals[perm])
    assert csr[1].dtype == np.int32 and csr[2].dtype == np.float32
    got = kernel_c_walk(tiled.n_rows, x, *csr)
    want = port_tiled.spmm_tiled_plain(tiled, torch.from_numpy(x)).numpy()
    assert_close_rel(got, want)
    if row_hi is not None:
        assert not got[row_hi:].any()


def test_stripe_index_rejects_a_non_cell_major_layout():
    _, pg = both(*coo(2, 300, 300, 2000), 300, 300)
    tiled = port_tiled.tile_graph(pg, 64, 64, 16)
    start = tiled.cell_start.copy()
    start[0, 0], start[0, 1] = start[0, 1], start[0, 0]
    with pytest.raises(ValueError, match="cell-major"):
        port_tiled.stripe_index(dataclasses.replace(tiled, cell_start=start))


# (n_rows, n_cols, f, R, W, C, row_hi): several 256-lane feature tiles;
# rectangular; empty row blocks
SPMM_CASES = {
    "feature_tiles": (700, 700, 300, 256, 256, 64, None),
    "rectangular": (200, 500, 40, 128, 128, 64, None),
    "empty_row_blocks": (600, 600, 32, 128, 256, 64, 100),
}


@pytest.mark.parametrize("entry", ["flat", "stripes"])
@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_tiled_spmm_matches_reference_interpret(entry, case):
    n_rows, n_cols, f, R, W, C, row_hi = SPMM_CASES[case]
    rg, pg = both(*coo(3, n_rows, n_cols, 4000, row_hi=row_hi), n_rows,
                  n_cols)
    x = features(4, n_cols, f)
    ref_fn = (ref_pallas.spmm_pallas_flat if entry == "flat"
              else ref_pallas.spmm_pallas_tiled)
    want = np.asarray(ref_fn(ref_pallas.tile_graph(rg, R, W, C),
                             jnp.asarray(x), interpret=True,
                             precision="f32"))[:n_rows, :f]
    port_fn = (port_tiled.spmm_tiled_flat if entry == "flat"
               else port_tiled.spmm_tiled_stripes)
    got = port_fn(port_tiled.tile_graph(pg, R, W, C), torch.from_numpy(x))
    assert got.shape == (n_rows, f) and got.dtype == torch.float32
    assert_close_rel(got.numpy(), want)
    if row_hi is not None:
        assert not got[row_hi:].any()


@pytest.mark.parametrize("entry", ["flat", "stripes"])
@pytest.mark.parametrize("case", sorted(SPMM_CASES))
def test_tiled_spmm_bf16_matches_reference_interpret(entry, case):
    """precision="bf16": each slot adds bf16(val * bf16(x[col])) on both
    sides, so only the f32 sum order differs; the result is a different
    function from "f32"."""
    n_rows, n_cols, f, R, W, C, row_hi = SPMM_CASES[case]
    rg, pg = both(*coo(3, n_rows, n_cols, 4000, row_hi=row_hi), n_rows,
                  n_cols)
    x = features(4, n_cols, f)
    ref_fn = (ref_pallas.spmm_pallas_flat if entry == "flat"
              else ref_pallas.spmm_pallas_tiled)
    want = np.asarray(ref_fn(ref_pallas.tile_graph(rg, R, W, C),
                             jnp.asarray(x), interpret=True,
                             precision="bf16"))[:n_rows, :f]
    port_fn = (port_tiled.spmm_tiled_flat if entry == "flat"
               else port_tiled.spmm_tiled_stripes)
    tiled = port_tiled.tile_graph(pg, R, W, C)
    got = port_fn(tiled, torch.from_numpy(x), precision="bf16")
    assert got.shape == (n_rows, f) and got.dtype == torch.float32
    assert_close_rel(got.numpy(), want)
    f32 = port_fn(tiled, torch.from_numpy(x)).numpy()
    assert float(np.abs(f32 - want).max()) > 10 * TOL * float(
        np.abs(want).max())
    if row_hi is not None:
        assert not got[row_hi:].any()


def test_tiled_spmm_rejects_unknown_precision():
    _, pg = both(*coo(5, 96, 96, 400), 96, 96)
    tiled = port_tiled.tile_graph(pg, 32, 32, 16)
    with pytest.raises(ValueError, match="precision"):
        port_tiled.spmm_tiled_flat(tiled, torch.ones(96, 4), precision="tf32")


def test_spmm_tiled_caches_the_tiling():
    rg, pg = both(*coo(5, 96, 96, 400), 96, 96)
    x = features(6, 96, 8)
    clear_placed()
    first = port_tiled._tile_cached(pg, 32, 32, 16, torch.device("cpu"))
    got = port_tiled.spmm_tiled(pg, torch.from_numpy(x), 32, 32, 16)
    again = port_tiled._tile_cached(pg, 32, 32, 16, torch.device("cpu"))
    assert again[0] is first[0] and again[1] is first[1]
    clear_placed()
    assert port_tiled._tile_cached(pg, 32, 32, 16, "cpu")[0] is not first[0]
    clear_placed()
    want = ref_pallas.spmm_pallas(rg, jnp.asarray(x), 32, 32, 16,
                                  interpret=True)
    assert_close_rel(got.numpy(), want)


# planted dense cells of a 256-node graph under 64 x 64 cells, chunk 32
# (the reference's own hybrid test sizes); min_fill picks the regime
SPLIT_CASES = {
    "mixed": (((0, 0), (2, 1)), 900, 100, 0.5),
    "all_sparse": ((), 0, 300, 0.9),
    "all_dense": (((0, 0),), 4000, 0, 0.5),
}


def split_case(case):
    cells, per_cell, n_sparse, min_fill = SPLIT_CASES[case]
    n = 64 if case == "all_dense" else 256
    rows, cols, vals = coo(7, n, n, n_sparse, cells, per_cell)
    return both(rows, cols, vals, n, n), n, min_fill


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_dense_cells_matches_reference(case):
    (rg, pg), n, min_fill = split_case(case)
    kw = dict(row_block=64, stripe=64, chunk=32, min_fill=min_fill)
    ref = ref_hybrid.split_dense_cells(rg, 96, **kw)
    port = port_hybrid.split_dense_cells(pg, 96, **kw)
    for name in ("n_rows", "n_cols", "dense_edges", "sparse_edges", "pad",
                 "min_fill"):
        assert getattr(ref, name) == getattr(port, name), name
    assert (ref.tiled is None) == (port.tiled is None)
    assert (ref.rest is None) == (port.rest is None)
    assert {"all_sparse": port.tiled is None, "all_dense": port.rest is None,
            "mixed": port.tiled is not None and port.rest is not None}[case]
    if port.tiled is not None:
        assert_tiled_equal(ref.tiled, port.tiled)
    if port.rest is not None:
        for name in ("rows", "cols", "vals", "row_ptr"):
            np.testing.assert_array_equal(np.asarray(getattr(ref.rest, name)),
                                          getattr(port.rest, name))
        assert ref.rest.nnz == port.rest.nnz

    x = features(8, n, 33)
    want = ref_hybrid.spmm_hybrid_split(ref, jnp.asarray(x), interpret=True,
                                        precision="f32")
    got = port_hybrid.spmm_hybrid_split(port, torch.from_numpy(x))
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_dense_cells_bf16_matches_reference(case):
    """The hybrid hop at precision "bf16": kernel C's bf16 dense part plus
    the f32 remainder, on both sides; the drop-in ``spmm_hybrid`` agrees."""
    (rg, pg), n, min_fill = split_case(case)
    kw = dict(row_block=64, stripe=64, chunk=32, min_fill=min_fill)
    ref = ref_hybrid.split_dense_cells(rg, 96, **kw)
    port = port_hybrid.split_dense_cells(pg, 96, **kw)
    x = features(8, n, 33)
    want = ref_hybrid.spmm_hybrid_split(ref, jnp.asarray(x), interpret=True,
                                        precision="bf16")
    got = port_hybrid.spmm_hybrid_split(port, torch.from_numpy(x),
                                        precision="bf16")
    assert_close_rel(got.numpy(), want)
    clear_placed()
    drop_in = port_hybrid.spmm_hybrid(pg.to("cpu"), torch.from_numpy(x),
                                      precision="bf16", **kw)
    clear_placed()
    assert_close_rel(drop_in.numpy(), want)


def test_min_fill_for_matches_reference():
    for args in ((512, 512, 602), (1024, 1024, 602), (64, 64, 96),
                 (512, 512, 1200)):
        assert port_hybrid.min_fill_for(*args) == \
            ref_hybrid.min_fill_for(*args)


def test_empty_hybrid_split_returns_zeros():
    split = port_hybrid.HybridSplit(tiled=None, rest=None, n_rows=16,
                                    n_cols=16, dense_edges=0, sparse_edges=0,
                                    pad=1.0, min_fill=0.5)
    out = port_hybrid.spmm_hybrid_split(split, torch.ones(16, 8))
    assert out.shape == (16, 8) and not out.any()


@contextlib.contextmanager
def reference_native_lpa(timeout: float = 60.0):
    """Hold the reference's native LPA solver for the block. Parallel
    workers build the reference's host library in place, unlocked, so a
    worker can load a half-written file, latch the failure and fall back
    to its numpy LPA, a different fixpoint. Under a file lock, clear the
    latch and retry until the library loads (fail the test if it never
    does); inside the block the fallback's warning is an error."""
    path = os.path.join(tempfile.gettempdir(), "sgc_tpu_native_ref.lock")
    with open(path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + timeout
        while not ref_native.available():
            if time.monotonic() > deadline:
                pytest.fail("the reference's native library does not load;"
                            " its numpy LPA is not a reference for the port")
            ref_native._lib, ref_native._load_failed = None, False
            time.sleep(0.5)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="lpa_order: native library")
        yield


# ------------------------------------------------------ the onehot plan

# scale 0.005 of the clustered synthetic (1,165 nodes), 24 of its 602
# feature columns, 128 x 128 cells; chunk 1024 (the plan's) and an
# explicit min_fill, so that both parts are populated
PLAN_KW = dict(row_block=128, stripe=128, min_fill=0.3)
# the reference's own onehot tolerance (tests/test_locality.py TOLS)
ONEHOT_TOLS = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def onehot_plans():
    g, x, labels, idx = ref_data(0.005, shuffle=True, device=False)
    with reference_native_lpa():
        ref = RefPlan.build(g, x[:, :24], labels, idx,
                            formulation="onehot", **PLAN_KW)
    g, x, labels, idx = synthetic_reddit_clustered(0.005, shuffle=True)
    port = LocalityPlan.build(g, x[:, :24], labels, idx,
                              formulation="onehot", device="cpu", **PLAN_KW)
    return ref, port


def test_onehot_plan_layout_matches_reference(onehot_plans):
    ref, port = onehot_plans
    assert port.formulation == "onehot"
    np.testing.assert_array_equal(ref.order, port.order)
    np.testing.assert_array_equal(ref.idx_train, port.idx_train)
    assert port.dense_fraction == ref.dense_fraction
    for r, p in ((ref.split_main, port.split_main),
                 (ref.split_final, port.split_final)):
        assert isinstance(p, port_hybrid.HybridSplit)
        assert p.tiled is not None and p.rest is not None
        assert (r.dense_edges, r.sparse_edges, r.pad, r.min_fill) == (
            p.dense_edges, p.sparse_edges, p.pad, p.min_fill)
        assert_tiled_equal(r.tiled, p.tiled)
        np.testing.assert_array_equal(np.asarray(r.rest.cols), p.rest.cols)


def test_onehot_khop_matches_reference_interpret(onehot_plans):
    ref, port = onehot_plans
    khop, args = ref.khop_traceable(degree=2, interpret=True)
    want = np.asarray(khop(jnp.asarray(ref.features), args))
    khop, args = port.khop_traceable(degree=2)
    got = khop(torch.as_tensor(port.features), args).numpy()
    np.testing.assert_allclose(got, want, **ONEHOT_TOLS)
    assert_close_rel(got, want)
    assert np.array_equal(port.propagate_train(2).numpy(), got)


def test_onehot_propagate_all_matches_reference(onehot_plans):
    ref, port = onehot_plans
    want = np.asarray(ref.propagate_all(degree=1, interpret=True))
    got = port.propagate_all(degree=1).numpy()
    np.testing.assert_allclose(got, want, **ONEHOT_TOLS)
    assert_close_rel(got, want)


# relative to max|ref| after two bf16 hops: the second hop rounds the
# first hop's f32 output, which differs from the reference's in its last
# bits, to bf16, so a value near a rounding boundary may round the other
# way (one bf16 step is 2**-8 of it)
ONEHOT_BF16_K2_TOL = 1e-4


def onehot_hops(plan, entry, degree, ref=False):
    """``degree`` hops at precision "bf16" through one of the plan's entry
    points (the reference's in interpret mode when ``ref``)."""
    kw = {"interpret": True} if ref else {}
    x = jnp.asarray(plan.features) if ref else torch.as_tensor(plan.features)
    if entry == "hop_fns":
        full, final = plan.hop_fns("bf16", **kw)
        for _ in range(degree - 1):
            x = full(x)
        return final(x)
    if entry == "khop_traceable":
        khop, args = plan.khop_traceable(degree, precision="bf16", **kw)
        return khop(x, args)
    if entry == "propagate_train":
        return plan.propagate_train(degree, precision="bf16", **kw)
    return plan.propagate_all(degree, precision="bf16", **kw)


@pytest.mark.parametrize("entry", ["hop_fns", "khop_traceable",
                                   "propagate_train", "propagate_all"])
def test_onehot_bf16_matches_reference(onehot_plans, entry):
    """The onehot plan at precision "bf16" (kernel C's bf16 dense part)
    against the reference's, through each entry point: one hop at 1e-5,
    two hops at ONEHOT_BF16_K2_TOL; and "bf16" is not "f32"."""
    ref, port = onehot_plans
    for degree, tol in ((1, TOL), (2, ONEHOT_BF16_K2_TOL)):
        want = np.asarray(onehot_hops(ref, entry, degree, ref=True))
        got = onehot_hops(port, entry, degree).numpy()
        assert_close_rel(got, want, tol)
    f32 = {"hop_fns": lambda: port.hop_fns()[1](
               torch.as_tensor(port.features)),
           "khop_traceable": lambda: port.propagate_train(1),
           "propagate_train": lambda: port.propagate_train(1),
           "propagate_all": lambda: port.propagate_all(1)}[entry]().numpy()
    one = onehot_hops(port, entry, 1).numpy()
    assert float(np.abs(one - f32).max()) > 10 * TOL * float(
        np.abs(f32).max())


@pytest.mark.parametrize("formulation", ["auto", "blockdense",
                                         "blockdense_kernel"])
def test_min_fill_with_blockdense_raises(formulation):
    g, x, labels, idx = synthetic_reddit_clustered(0.002)
    with pytest.raises(ValueError, match="min_fill"):
        LocalityPlan.build(g, x, labels, idx, formulation=formulation,
                           min_fill=0.3, device="cpu")


# --------------------------------------------------------- the dispatcher

@pytest.fixture(scope="module")
def dispatch_problem():
    """Two 512 x 512 cells dense enough for both admissions (3,000 edges:
    above the block-dense 439-edge crossover and the one-hot fill), a
    sparse tail and a ragged feature count."""
    n = 1200
    rows, cols, vals = coo(9, n, n, 2000, ((0, 0), (1, 1)), 3000, cell=512)
    rg, pg = both(rows, cols, vals, n, n)
    x = features(10, n, 16)
    return rg, pg.to("cpu"), x


@pytest.mark.parametrize("impl,ref_impl", [
    ("auto", "auto"), ("segment", "segment"), ("chunked", "chunked"),
    ("tiled", "pallas"), ("hybrid", "hybrid"), ("blockdense", "blockdense")])
def test_spmm_dispatcher_matches_reference(dispatch_problem, impl,
                                           ref_impl):
    rg, pg, x = dispatch_problem
    want = np.asarray(ref_spmm(rg, jnp.asarray(x), impl=ref_impl))
    got = port_spmm.spmm(pg, torch.from_numpy(x), impl=impl)
    assert got.shape == (pg.n_rows, x.shape[1])
    assert_close_rel(got.numpy(), want, TOL)


def test_segment_and_chunked_agree_bitwise(dispatch_problem):
    _, pg, x = dispatch_problem
    xt = torch.from_numpy(x)
    seg = port_spmm.spmm(pg, xt, impl="segment")
    for chunk in (1000, 4096, 1 << 20):
        assert torch.equal(port_spmm.spmm(pg, xt, impl="chunked",
                                          chunk=chunk), seg)


def test_spmm_auto_follows_the_reference_cpu_rule(dispatch_problem,
                                                  monkeypatch):
    _, pg, x = dispatch_problem
    picked = []
    monkeypatch.setattr(port_spmm, "spmm_chunked",
                        lambda g, x, chunk: picked.append("chunked"))
    monkeypatch.setattr(port_spmm, "spmm_segment",
                        lambda g, x: picked.append("segment"))
    port_spmm.spmm(pg, torch.from_numpy(x))
    monkeypatch.setattr(port_spmm, "_SEGMENT_ELEM_BUDGET", 1000)
    port_spmm.spmm(pg, torch.from_numpy(x))
    assert picked == ["segment", "chunked"]


def test_spmm_rejects_unknown_impl_and_host_graph(dispatch_problem):
    rg, pg, x = dispatch_problem
    with pytest.raises(ValueError, match="unknown spmm impl"):
        port_spmm.spmm(pg, torch.from_numpy(x), impl="pallas")
    host = PortGraph.from_coo(np.array([0]), np.array([0]),
                              np.ones(1, np.float32), 1, 1)
    with pytest.raises(ValueError, match="graph on None"):
        port_spmm.spmm(host, torch.ones(1, 3))


# ------------------------------------------------------- capability case

def test_capability_hybrid_case_is_built_as_described():
    """The CUDA capability check's kernel C/D case has an empty row block,
    padding slots, a dense and a sparse part and a ragged feature count;
    its plain product equals the all-segment one."""
    from sgc_tpu_torch.ops.capability import hybrid_case

    graph, split, x = hybrid_case()
    tiled = split.tiled
    assert split.tiled is not None and split.rest is not None
    assert tiled.n_row_blocks == 3 and tiled.n_rows % tiled.row_block
    ptr, _ = port_tiled.flat_index(tiled)
    chunks_per_rb = np.diff(ptr)
    assert (chunks_per_rb == 0).any() and (chunks_per_rb > 0).sum() >= 2
    assert tiled.rows.shape[0] > split.dense_edges      # padding slots
    assert x.shape[1] % 32
    rest_rows = np.asarray(split.rest.rows[: split.rest.nnz])
    assert not ((rest_rows >= 512) & (rest_rows < 1024)).any()
    got = port_hybrid.spmm_hybrid_split(split, x)
    want = port_spmm.spmm_segment(graph.to("cpu"), x)
    assert_close_rel(got.numpy(), want.numpy())
