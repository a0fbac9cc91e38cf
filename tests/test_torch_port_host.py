"""Host-side parity of the PyTorch port (sgc_tpu_torch) with sgc_tpu.

Both packages get the same numpy inputs; every host array must match bit
for bit: graph containers, normalization, synthetic data, the LPA order
and the block-dense split (cells' bf16 bits, ids and remainder).
"""

import contextlib
import fcntl
import os
import tempfile
import time
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

from sgc_tpu import native as ref_native
from sgc_tpu.data import synthetic as ref_synth
from sgc_tpu.graph import normalize as ref_norm
from sgc_tpu.graph import reorder as ref_reorder
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops import spmm_blockdense as ref_bd

from sgc_tpu_torch.data import synthetic as port_synth
from sgc_tpu_torch.graph import normalize as port_norm
from sgc_tpu_torch.graph import reorder as port_reorder
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.ops import spmm_blockdense as port_bd

GRAPH_FIELDS = ("rows", "cols", "vals", "row_ptr")


def assert_graphs_equal(ref, port):
    assert (ref.n_rows, ref.n_cols, ref.nnz) == (
        port.n_rows, port.n_cols, port.nnz)
    for f in GRAPH_FIELDS:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(port, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


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


@pytest.fixture(scope="module")
def clustered():
    """(reference data, port data) at scale 0.02, shuffled ids."""
    ref = ref_synth.synthetic_reddit_clustered(0.02, shuffle=True,
                                               device=False)
    port = port_synth.synthetic_reddit_clustered(0.02, shuffle=True)
    return ref, port


@pytest.fixture(scope="module")
def reordered(clustered):
    ref, port = clustered
    with reference_native_lpa():
        want = ref_reorder.reorder_graph_arrays(ref[0], "lpa", *ref[1:])
    return want, port_reorder.reorder_graph_arrays(port[0], "lpa", *port[1:])


def _random_coo(seed, n=300, m=2000, dup=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n + 7, m)
    if dup:  # repeat some edges: from_coo keeps duplicates
        rows = np.concatenate([rows, rows[:50]])
        cols = np.concatenate([cols, cols[:50]])
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals, n, n + 7


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pad_multiple", [1024, 128])
def test_from_coo_matches_reference(seed, pad_multiple):
    rows, cols, vals, n_r, n_c = _random_coo(seed)
    ref = RefGraph.from_coo(rows, cols, vals, n_r, n_c, pad_multiple,
                            device=False)
    port = PortGraph.from_coo(rows, cols, vals, n_r, n_c, pad_multiple)
    assert_graphs_equal(ref, port)
    assert port.n_edges_padded % pad_multiple == 0


def test_from_coo_presorted_matches_and_rejects_unsorted():
    rows, cols, vals, n_r, n_c = _random_coo(2, dup=False)
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    ref = RefGraph.from_coo(r, c, v, n_r, n_c, device=False, presorted=True)
    port = PortGraph.from_coo(r, c, v, n_r, n_c, presorted=True)
    assert_graphs_equal(ref, port)
    with pytest.raises(ValueError, match="not \\(row, col\\)-sorted"):
        PortGraph.from_coo(rows, cols, vals, n_r, n_c, presorted=True)


def test_from_scipy_to_scipy_and_with_vals():
    rows, cols, vals, n_r, n_c = _random_coo(3)
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(n_r, n_c)).tocsr()
    ref = RefGraph.from_scipy(mat, device=False)
    port = PortGraph.from_scipy(mat)
    assert_graphs_equal(ref, port)
    back = port.to_scipy().tocsr()
    assert abs(back - mat).max() == 0
    newv = np.arange(port.n_edges_padded, dtype=np.float32)
    assert port.with_vals(newv).vals is newv


@pytest.mark.parametrize("ascending", [True, False])
def test_row_subgraph_matches_reference(ascending):
    rows, cols, vals, n_r, n_c = _random_coo(4)
    ref = RefGraph.from_coo(rows, cols, vals, n_r, n_c, device=False)
    port = PortGraph.from_coo(rows, cols, vals, n_r, n_c)
    idx = np.random.default_rng(5).choice(n_r, 120, replace=False)
    idx = np.sort(idx) if ascending else idx
    assert_graphs_equal(ref.row_subgraph(idx), port.row_subgraph(idx))
    with pytest.raises(ValueError, match="unique"):
        port.row_subgraph(np.array([1, 1]))
    with pytest.raises(ValueError, match="must be in"):
        port.row_subgraph(np.array([-1]))


def test_aug_normalized_adjacency_matches_reference():
    rng = np.random.default_rng(6)
    n = 200
    a = sp.coo_matrix((np.ones(900, np.float32),
                       (rng.integers(0, n, 900), rng.integers(0, n, 900))),
                      shape=(n, n))
    a = a + a.T
    ref = ref_norm.aug_normalized_adjacency(a)
    port = port_norm.fetch_normalization("AugNormAdj")(a)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(port, f))
    with pytest.raises(ValueError, match="Invalid normalization"):
        port_norm.fetch_normalization("nope")


def test_synthetic_clustered_shuffled_matches_reference(clustered):
    (rg, rf, rl, ri), (pg, pf, pl, pi) = clustered
    assert_graphs_equal(rg, pg)
    for a, b in ((rf, pf), (rl, pl), (ri, pi)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (pg.n_rows, pg.nnz) == (4659, 184991)


@pytest.mark.parametrize("kind,kwargs", [
    ("clustered", dict(scale=0.005, shuffle=False, tail="powerlaw")),
    ("uniform", dict(scale=0.005)),
])
def test_synthetic_variants_match_reference(kind, kwargs):
    if kind == "clustered":
        ref = ref_synth.synthetic_reddit_clustered(device=False, **kwargs)
        port = port_synth.synthetic_reddit_clustered(**kwargs)
    else:
        ref = ref_synth.synthetic_reddit(**kwargs)
        port = port_synth.synthetic_reddit(**kwargs)
    assert_graphs_equal(ref[0], port[0])
    for a, b in zip(ref[1:], port[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lpa_order_and_permuted_arrays_match_reference(reordered, clustered):
    (rg, rf, rl, ri, ro), (pg, pf, pl, pi, po) = reordered
    np.testing.assert_array_equal(ro, po)
    assert_graphs_equal(rg, pg)
    for a, b in ((rf, pf), (rl, pl), (ri, pi)):
        np.testing.assert_array_equal(a, b)
    # the adjacency entry point reaches the same (native) fixpoint
    adj = clustered[1][0].to_scipy().tocsr()
    np.testing.assert_array_equal(
        ref_reorder.lpa_order(adj, impl="native"), port_reorder.lpa_order(adj))


def test_reference_lpa_guard_restores_the_native_solver(monkeypatch,
                                                       clustered):
    """With the reference's load failure latched, its ``auto`` LPA falls
    back to the numpy solver (with a warning); the guard clears the
    latch, so the same call reaches the native fixpoint, the port's."""
    adj = clustered[0][0].to_scipy().tocsr()
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_load_failed", True)
    assert not ref_native.available()
    with pytest.warns(UserWarning, match="native library unavailable"):
        ref_reorder.lpa_order(adj, max_iter=1)
    with reference_native_lpa():
        assert ref_native.available() and not ref_native._load_failed
        got = ref_reorder.lpa_order(adj)
    np.testing.assert_array_equal(got, port_reorder.lpa_order(adj))


def test_reorder_rejects_unported_orderings(clustered):
    g, f, l, i = clustered[1]
    with pytest.raises(NotImplementedError, match="rcm"):
        port_reorder.reorder_graph_arrays(g, "rcm", f, l, i)


@pytest.mark.parametrize("super_rows,group_cells,min_edges", [
    (None, None, None),          # classic order, committed admission
    (8, None, None),             # super-row order (the kernel form)
    (8, None, 4000.0),           # partial admission
    (4, 2, 1500.0),              # grouped layout with zero holes
])
def test_split_block_dense_matches_reference(reordered, super_rows,
                                             group_cells, min_edges):
    rg, pg = reordered[0][0], reordered[1][0]
    ref = ref_bd.split_block_dense(rg, 602, min_edges=min_edges,
                                   super_rows=super_rows,
                                   group_cells=group_cells)
    port = port_bd.split_block_dense(pg, 602, min_edges=min_edges,
                                     super_rows=super_rows,
                                     group_cells=group_cells)
    np.testing.assert_array_equal(ref.cells.view(np.uint16), port.cells)
    np.testing.assert_array_equal(ref.rb_ids, port.rb_ids)
    np.testing.assert_array_equal(ref.st_ids, port.st_ids)
    for f in ("n_cells", "dense_edges", "sparse_edges", "min_edges",
              "n_row_blocks", "n_stripes"):
        assert getattr(ref, f) == getattr(port, f), f
    assert (ref.rest is None) == (port.rest is None)
    if ref.rest is not None:
        assert_graphs_equal(ref.rest, port.rest)
    assert port.n_cells > 0


def test_split_index_orders_row_blocks_by_stripe(reordered):
    """The kernel's per-row-block index: every slot before the tail once,
    grouped by row block, ascending stripe inside, for both orders."""
    pg = reordered[1][0]
    for sr, gc in ((None, None), (8, None), (4, 2)):
        split = port_bd.split_block_dense(pg, 602, min_edges=1500.0,
                                          super_rows=sr, group_cells=gc)
        rb_ptr, cell_of = port_bd.cell_index(split)
        assert sorted(cell_of.tolist()) == list(range(split.n_slots))
        for rb in range(split.n_row_blocks):
            slots = cell_of[rb_ptr[rb]:rb_ptr[rb + 1]]
            assert (split.rb_ids[slots] == rb).all()
            assert (np.diff(split.st_ids[slots]) >= 0).all()


def test_admission_constants_match_reference():
    assert port_bd.BLOCKDENSE_EFF_FLOPS == ref_bd.BLOCKDENSE_EFF_FLOPS
    assert port_bd.XLA_EDGES_PER_S == ref_bd.XLA_EDGES_PER_S
    for args in ((512, 512, 602), (128, 256, 37), (64, 64, 1000)):
        assert port_bd.min_edges_for(*args) == ref_bd.min_edges_for(*args)
    for f in (1, 100, 602, 1500):
        assert (port_bd.default_feature_tile(f)
                == ref_bd.default_feature_tile(f))
