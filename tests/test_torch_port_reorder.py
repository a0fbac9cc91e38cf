"""The port's node orderings (``sgc_tpu_torch/graph/reorder.py``) against
the reference's, bit for bit, on the same seeded graphs: a shuffled
stochastic block model, a disconnected one and one with isolated nodes.

Each ordering's permutation, ``apply_order`` / ``remap_indices``, and
``reorder_graph_arrays`` for every name (graph arrays, features, labels,
``idx`` and ``order``) are equal exactly, since both packages run the
same scipy calls (or, for LPA, the same native solver) on the host.
ARPACK starts ``eigsh`` from a random vector that changes from call to
call within a process, so the spectral order is not reproducible even in
the reference; ``pinned_eigsh`` gives both packages' calls the same
seeded start vector, which makes the shared inputs complete.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from sgc_tpu.graph import reorder as ref_ro
from sgc_tpu.graph.sparse import SparseGraph as RefGraph

from sgc_tpu_torch.graph import reorder as port_ro
from sgc_tpu_torch.graph.sparse import SparseGraph

from test_torch_port_slice import reference_native_lpa

NAMES = ("rcm", "bfs", "degree", "spectral", "lpa", "none")


def pin_eigsh(monkeypatch):
    """Start every ``scipy.sparse.linalg.eigsh`` call from the same
    seeded vector (both packages import it from there at call time)."""
    eigsh = spla.eigsh

    def pinned(a, *pos, **kw):
        kw.setdefault("v0", np.random.default_rng(0).random(a.shape[0]))
        return eigsh(a, *pos, **kw)

    monkeypatch.setattr(spla, "eigsh", pinned)


@pytest.fixture(autouse=True)
def pinned_eigsh(monkeypatch):
    pin_eigsh(monkeypatch)


def sbm(n_clusters=4, per=64, p_in=0.2, p_out=0.01, seed=0):
    """A stochastic block model with shuffled node ids (symmetric)."""
    rng = np.random.default_rng(seed)
    n = n_clusters * per
    blocks = np.repeat(np.arange(n_clusters), per)
    r, c = np.triu_indices(n, 1)
    keep = rng.random(len(r)) < np.where(blocks[r] == blocks[c], p_in, p_out)
    adj = sp.coo_matrix((rng.random(int(keep.sum())).astype(np.float32) + 0.5,
                         (r[keep], c[keep])), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    shuffle = rng.permutation(n)
    return adj[shuffle][:, shuffle].tocsr()


def disconnected():
    """Three SBMs of different sizes with no edge between them."""
    parts = [sbm(3, 40, seed=1, p_out=0.0), sbm(2, 30, seed=2, p_out=0.0),
             sbm(2, 50, seed=3, p_out=0.02)]
    return sp.block_diag(parts).tocsr()


def with_isolated():
    """An SBM plus 25 nodes with no edge, ids interleaved."""
    adj = sbm(3, 50, seed=4)
    n = adj.shape[0] + 25
    perm = np.random.default_rng(5).permutation(n)
    coo = adj.tocoo()
    return sp.coo_matrix((coo.data, (perm[coo.row], perm[coo.col])),
                         shape=(n, n)).tocsr()


GRAPHS = {"sbm": sbm, "disconnected": disconnected,
          "isolated": with_isolated}


def ordering(pkg, name, adj, **kw):
    if name == "lpa":
        if pkg is ref_ro:
            with reference_native_lpa():
                return ref_ro.lpa_order(adj, impl="native")
        return port_ro.lpa_order(adj)
    return pkg.fetch_ordering(name)(adj, **kw)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", NAMES)
def test_ordering_equals_reference(graph, name):
    adj = GRAPHS[graph]()
    want = ordering(ref_ro, name, adj)
    got = ordering(port_ro, name, adj)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(adj.shape[0]))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_degree_order_ascending_equals_reference(graph):
    adj = GRAPHS[graph]()
    np.testing.assert_array_equal(
        port_ro.degree_order(adj, descending=False),
        ref_ro.degree_order(adj, descending=False))


def test_spectral_falls_back_to_rcm_as_reference(monkeypatch):
    """With ``eigsh`` raising, every component is ordered by RCM in both
    packages, and so is the whole order."""
    adj = disconnected()

    def fails(*a, **k):
        raise RuntimeError("no convergence")

    monkeypatch.setattr(spla, "eigsh", fails)
    want = ref_ro.spectral_order(adj)
    got = port_ro.spectral_order(adj)
    np.testing.assert_array_equal(got, want)
    # and the fallback really ran: the first (largest) component's
    # positions are its own RCM order
    n_comp, comp = sp.csgraph.connected_components(adj, directed=False)
    sizes = np.bincount(comp)
    first = np.where(comp == sizes.argmax())[0]
    sub = adj[first][:, first]
    np.testing.assert_array_equal(got[:len(first)],
                                  first[port_ro.rcm_order(sub)])


def test_apply_order_and_remap_round_trip():
    adj = with_isolated()
    n = adj.shape[0]
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    order = port_ro.rcm_order(adj)
    padj, pf, pl = port_ro.apply_order(adj, order, feats, labels)
    radj, rf, rl = ref_ro.apply_order(adj, order, feats, labels)
    assert (padj != radj).nnz == 0
    np.testing.assert_array_equal(pf, rf)
    np.testing.assert_array_equal(pl, rl)
    # back: the inverse permutation restores every array
    inv = port_ro.remap_indices(order, np.arange(n))
    back, bf, bl = port_ro.apply_order(padj, inv, pf, pl)
    assert (back != adj).nnz == 0
    np.testing.assert_array_equal(bf, feats)
    np.testing.assert_array_equal(bl, labels)
    idx = rng.choice(n, 20, replace=False)
    new = port_ro.remap_indices(order, idx)
    np.testing.assert_array_equal(new, ref_ro.remap_indices(order, idx))
    np.testing.assert_array_equal(order[new], idx)


def _graph_pair(adj, duplicates=False):
    coo = adj.tocoo()
    rows, cols, vals = coo.row, coo.col, coo.data.astype(np.float32)
    if duplicates:
        rows = np.concatenate([rows, rows[:40]])
        cols = np.concatenate([cols, cols[:40]])
        vals = np.concatenate([vals, vals[:40] * 0.5])
    n = adj.shape[0]
    return (SparseGraph.from_coo(rows, cols, vals, n, n),
            RefGraph.from_coo(rows, cols, vals, n, n, device=False))


@pytest.mark.parametrize("name", NAMES)
def test_reorder_graph_arrays_equals_reference(name):
    adj = with_isolated()
    n = adj.shape[0]
    pg, rg = _graph_pair(adj, duplicates=True)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    idx = rng.choice(n, 30, replace=False)
    got = port_ro.reorder_graph_arrays(pg, name, feats, labels, idx)
    if name == "lpa":
        with reference_native_lpa():
            want = ref_ro.reorder_graph_arrays(rg, name, feats, labels, idx)
    else:
        want = ref_ro.reorder_graph_arrays(rg, name, feats, labels, idx)
    g, w = got[0], want[0]
    assert (g.n_rows, g.n_cols, g.nnz) == (w.n_rows, w.n_cols, w.nnz)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f)))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


def test_fetch_ordering_rejects_unknown_name_as_reference():
    with pytest.raises(ValueError) as want:
        ref_ro.fetch_ordering("metis")
    with pytest.raises(ValueError) as got:
        port_ro.fetch_ordering("metis")
    assert str(got.value) == str(want.value)
    assert list(port_ro.ORDERINGS) == list(ref_ro.ORDERINGS)
    pg, _ = _graph_pair(sbm())
    with pytest.raises(ValueError, match="unknown ordering"):
        port_ro.reorder_graph_arrays(pg, "metis", np.zeros((256, 1)),
                                     np.zeros(256), np.arange(3))


def test_lpa_fast_path_matches_scipy_path():
    """The scipy-free LPA path (native coalesce, row_ptr, direct COO
    permute) gives the scipy path's arrays exactly: order, edges, values
    (duplicates summed), features, labels, idx."""
    rng = np.random.default_rng(4)
    n, e = 300, 4000
    r = rng.integers(0, n, e)
    c = rng.integers(0, n, e)
    r[100:150] = r[0]
    c[100:150] = c[0]
    v = rng.standard_normal(e).astype(np.float32)
    g = SparseGraph.from_coo(r, c, v, n, n)
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    idx = np.sort(rng.choice(n, 40, replace=False))
    fast = port_ro.reorder_graph_arrays(g, "lpa", feats, y, idx)
    slow = port_ro.reorder_scipy(g, "lpa", feats, y, idx)
    gf, gs = fast[0], slow[0]
    assert gf.nnz == gs.nnz
    for f in ("rows", "cols", "row_ptr"):
        np.testing.assert_array_equal(getattr(gf, f), getattr(gs, f))
    np.testing.assert_allclose(gf.vals, gs.vals, rtol=1e-6)
    for a, b in zip(fast[1:], slow[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 5, 42])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_lpa_sync_matches_reference(graph, seed):
    """``impl="sync"``, the reference's synchronous numpy solver, is its
    order bit for bit at every seed (the seed draws its tie-breaks)."""
    adj = GRAPHS[graph]()
    want = ref_ro.lpa_order(adj, seed=seed, impl="sync")
    got = port_ro.lpa_order(adj, seed=seed, impl="sync")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_lpa_takes_the_reference_arguments_in_order():
    """``(adj, max_iter, seed, min_moved, impl)`` as the reference's."""
    adj = GRAPHS["sbm"]()
    np.testing.assert_array_equal(
        port_ro.lpa_order(adj, 3, 7, 0.0, "sync"),
        ref_ro.lpa_order(adj, 3, 7, 0.0, "sync"))
    with pytest.raises(ValueError, match="unknown lpa impl"):
        port_ro.lpa_order(adj, impl="scipy")


def test_lpa_auto_is_native_and_raises_without_the_library(monkeypatch):
    """``"auto"`` means the native solver: without the library it raises,
    where the reference falls back to ``"sync"`` with a warning; ``"sync"``
    needs no library."""
    adj = GRAPHS["sbm"]()
    np.testing.assert_array_equal(port_ro.lpa_order(adj),
                                  port_ro.lpa_order(adj, impl="native"))
    monkeypatch.setattr(port_ro.native, "available", lambda: False)
    for impl in ("auto", "native"):
        with pytest.raises(RuntimeError, match="native graph-prep library"):
            port_ro.lpa_order(adj, impl=impl)
    np.testing.assert_array_equal(
        port_ro.lpa_order(adj, seed=5, impl="sync"),
        ref_ro.lpa_order(adj, seed=5, impl="sync"))
