"""Kernel B's row order (``sgc_tpu_torch/ops/spmm.py::row_walk``), on the
CPU: the permuted CSR the wrapper hands to ``csrc/spmm_csr.cu`` with its
row map, the rules that decide when the order engages, and the caches
that build it once per graph.

The kernel walks the permuted CSR's row r and writes the graph's row
``row_map[r]``; each row's edges stay in their ``row_ptr`` order, so its
sum is the same chain and the product keeps its bits. Here the plain
version of a row-mapped product (``spmm_walk_plain``) is held to
``spmm_segment_plain`` bit for bit; the card tests hold the kernel to
the same (tests/test_torch_port_row_order_cuda.py).

The order is built at the ``ORDER_RUN``-th launch in a row on one
pattern; ``engaged`` makes such a run. The graphs are small (a few
thousand nodes), so the tests set the L2 size (0 bytes unless a test
says otherwise) and shrink the measure's block to the graphs' scale.
"""

import numpy as np
import pytest
import torch

from sgc_tpu_torch.graph import reorder
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import autograd as ag
from sgc_tpu_torch.ops import spmm as sp
from sgc_tpu_torch.ops.autograd import fix_transpose_vals, on_transpose

N, COMMUNITIES = 2400, 12


def community_graph(seed=0, shuffle=True, intra=0.9, avg_degree=16):
    """COMMUNITIES blocks of N / COMMUNITIES nodes, ``intra`` of the
    edges inside a block, symmetric, ids shuffled when ``shuffle``."""
    rng = np.random.default_rng(seed)
    size = N // COMMUNITIES
    e = N * avg_degree // 2
    src = rng.integers(0, N, e)
    inside = rng.random(e) < intra
    dst = np.where(inside, src // size * size + rng.integers(0, size, e),
                   rng.integers(0, N, e))
    ids = rng.permutation(N) if shuffle else np.arange(N)
    rows = np.concatenate([ids[src], ids[dst], np.arange(N)])
    cols = np.concatenate([ids[dst], ids[src], np.arange(N)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return SparseGraph.from_coo(rows, cols, vals, N, N).to(
        torch.device("cpu"))


def uniform_graph(seed=0, avg_degree=16):
    rng = np.random.default_rng(seed)
    e = N * avg_degree
    rows, cols = rng.integers(0, N, e), rng.integers(0, N, e)
    vals = rng.standard_normal(e).astype(np.float32)
    return SparseGraph.from_coo(rows, cols, vals, N, N).to(
        torch.device("cpu"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small problems: when the suite runs
    in parallel workers, torch's thread pool is oversubscribed and its
    many short ops run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clear_orders():
    sp._ROW_ORDERS.clear()
    sp._ROW_WALKS.clear()
    sp._RUN[:] = [None, 0]


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Empty caches, and a block at the small graphs' scale (a few
    blocks a community, as ORDER_BLOCK is to the Reddit shape's)."""
    clear_orders()
    monkeypatch.setattr(sp, "ORDER_BLOCK", 200)
    monkeypatch.setattr(sp, "l2_bytes", lambda device: 0)
    yield
    clear_orders()


@pytest.fixture
def lpa_runs(monkeypatch):
    """Counts lpa_order's runs."""
    runs = []
    real = reorder.lpa_order

    def counted(adj, *a, **k):
        runs.append(adj.shape)
        return real(adj, *a, **k)

    monkeypatch.setattr(reorder, "lpa_order", counted)
    return runs


def engaged(graph, F=64, order_of=None):
    """The graph's walk at the last launch of a run of ``ORDER_RUN``
    (those before it go in index order)."""
    for _ in range(sp.ORDER_RUN - 1):
        assert sp.row_walk(graph, F, order_of) is None
    return sp.row_walk(graph, F, order_of)


def spmm_walk_plain(walk, x, dense=None):
    """What kernel B computes over ``walk`` in plain PyTorch: each walked
    row's sum (``spmm_segment_plain`` on the permuted CSR) written to its
    own row, plus ``dense``."""
    n = int(walk.row_ptr.shape[0]) - 1
    ptr = walk.row_ptr.long()
    walked = SparseGraph(
        rows=torch.repeat_interleave(torch.arange(n), ptr[1:] - ptr[:-1]).to(
            torch.int32),
        cols=walk.cols, vals=walk.vals, row_ptr=walk.row_ptr, n_rows=n,
        n_cols=int(x.shape[0]), nnz=int(ptr[-1]))
    out = torch.empty((n, x.shape[1]), dtype=torch.float32)
    out[walk.row_map.long()] = sp.spmm_segment_plain(walked, x)
    return out if dense is None else dense + out


def decided(graph):
    """The cached walked pattern (``()``: index order) or None."""
    return sp._ROW_ORDERS.find((graph.row_ptr, graph.cols), ())


def test_walk_keeps_each_rows_edges_in_order_and_maps_a_permutation():
    g = community_graph()
    order = torch.as_tensor(np.random.default_rng(1).permutation(N))
    ptr, cols, edge_perm, row_map = sp.walk_rows(g, order)
    assert row_map.dtype == torch.int32 and ptr.dtype == torch.int32
    assert torch.equal(torch.sort(row_map.long()).values, torch.arange(N))
    assert int(ptr[-1]) == g.nnz == cols.numel()
    assert edge_perm.dtype == torch.int32
    assert torch.equal(torch.sort(edge_perm.long()).values,
                       torch.arange(g.nnz))
    gp = g.row_ptr.long()
    for r in range(0, N, 97):
        src = int(row_map[r])
        lo, hi = int(ptr[r]), int(ptr[r + 1])
        assert torch.equal(edge_perm[lo:hi].long(),
                           torch.arange(int(gp[src]), int(gp[src + 1])))
        assert torch.equal(cols[lo:hi], g.cols[gp[src]:gp[src + 1]])


@pytest.mark.parametrize("with_dense", [False, True])
@pytest.mark.parametrize("F", [1, 8, 64])
def test_row_mapped_product_has_the_plain_products_bits(F, with_dense):
    g = community_graph()
    walk = engaged(g, F)
    assert walk is not None
    gen = torch.Generator().manual_seed(F)
    x = torch.randn(N, F, generator=gen)
    dense = torch.randn(N, F, generator=gen) if with_dense else None
    assert torch.equal(spmm_walk_plain(walk, x, dense),
                       sp.spmm_segment_plain(g, x, dense))


def test_lpa_order_engages_on_a_shuffled_graph(lpa_runs):
    g = community_graph()
    nnz = g.nnz
    assert sp.block_share(g.rows[:nnz], g.cols[:nnz]) < sp.ORDER_LOCAL_SHARE
    assert engaged(g) is not None
    assert len(lpa_runs) == 1


@pytest.mark.parametrize("F", [1, 8, 64])
def test_bypass_where_the_table_fits_the_l2(lpa_runs, monkeypatch, F):
    """A table of n x F f32 within the L2 keeps index order and costs
    nothing, however long the run: no measure, no LPA, no cache entry;
    a wider product on the same pattern takes the order."""
    g = community_graph()
    monkeypatch.setattr(sp, "l2_bytes", lambda device: 4 * N * F)
    for _ in range(3 * sp.ORDER_RUN):
        assert sp.row_walk(g, F) is None
    assert lpa_runs == [] and len(sp._ROW_ORDERS) == 0
    assert sp.row_walk(g, F + 1) is not None
    assert len(lpa_runs) == 1


def test_bypass_where_the_ids_are_already_local(lpa_runs):
    """A graph in community order (as the locality plan's LPA-ordered
    hops) reads local: no LPA run, index order, decided once."""
    g = community_graph(shuffle=False)
    assert engaged(g) is None
    assert decided(g) == ()
    assert lpa_runs == []


def test_bypass_where_lpa_finds_no_more_local_order(lpa_runs):
    """A graph with no communities: one LPA run, whose order is no more
    local, so index order stays (and LPA does not run again)."""
    g = uniform_graph()
    assert engaged(g) is None
    for _ in range(3 * sp.ORDER_RUN):
        assert sp.row_walk(g, 64) is None
    assert decided(g) == ()
    assert len(lpa_runs) == 1


def test_bypass_for_a_graph_that_is_not_square():
    g = community_graph().row_subgraph(np.arange(0, N, 2)).to(
        torch.device("cpu"))
    assert g.n_rows != g.n_cols
    for _ in range(3 * sp.ORDER_RUN):
        assert sp.row_walk(g, 64) is None
    assert len(sp._ROW_ORDERS) == 0


@pytest.mark.parametrize("hops", [2, 16, sp.ORDER_RUN - 1])
def test_bypass_for_runs_too_short_to_repay_the_build(lpa_runs, hops):
    """A K-hop precompute's hops, run after run with another graph's
    launches between them (a shallow model's layers and their
    transposes), never reach a run of ORDER_RUN: no LPA run, no entry."""
    g, other = community_graph(), community_graph(seed=1)
    for _ in range(20):
        for _ in range(hops):
            assert sp.row_walk(g, 64) is None
        assert sp.row_walk(other, 64) is None
    assert lpa_runs == [] and len(sp._ROW_ORDERS) == 0


def test_many_launches_build_one_order(lpa_runs):
    g = community_graph()
    walk = engaged(g)
    for _ in range(50):
        assert sp.row_walk(g, 64) is walk
        # a graph object of the same arrays is the same graph
        assert sp.row_walk(g.with_vals(g.vals), 64) is walk
    # once built, the order holds whatever runs come between
    assert sp.row_walk(community_graph(seed=1), 64) is None
    assert sp.row_walk(g, 64) is walk
    assert len(lpa_runs) == 1
    assert len(sp._ROW_ORDERS) == len(sp._ROW_WALKS) == 1


def test_the_order_cache_is_bounded(lpa_runs):
    graphs = [community_graph(seed=s) for s in range(10)]
    for g in graphs:
        assert engaged(g) is not None
    assert len(sp._ROW_ORDERS) <= 8 and len(sp._ROW_WALKS) <= 8
    assert len(lpa_runs) == 10


def test_new_values_never_read_a_copy_made_with_others():
    """GAT's reweightings share the row pointers and columns and bring
    new values each step: each gets the walked copy of its own values,
    and the pattern's order is not built again."""
    g = community_graph()
    walk = engaged(g)
    x = torch.randn(N, 8, generator=torch.Generator().manual_seed(5))
    for step in range(3):
        vals = torch.randn(g.vals.shape,
                           generator=torch.Generator().manual_seed(step))
        gv = g.with_vals(vals)
        wv = sp.row_walk(gv, 64)
        assert wv is not walk and wv.row_map is walk.row_map
        assert torch.equal(spmm_walk_plain(wv, x),
                           sp.spmm_segment_plain(gv, x))
    assert len(sp._ROW_ORDERS) == 1


def test_the_transpose_reuses_its_forward_graphs_order(lpa_runs):
    """The backward's cached transpose takes its forward graph's node
    order: one LPA run for both, and its own walked pattern."""
    g = fix_transpose_vals(community_graph())
    walk = engaged(g)
    gt = on_transpose(g, g.vals)
    walk_t = engaged(gt, order_of=g)
    assert walk_t is not None and len(lpa_runs) == 1
    assert torch.equal(walk_t.row_map, walk.row_map)
    x = torch.randn(N, 8, generator=torch.Generator().manual_seed(9))
    assert torch.equal(spmm_walk_plain(walk_t, x),
                       sp.spmm_segment_plain(gt, x))


def test_the_transpose_decides_first_when_launched_first(lpa_runs):
    """A transpose whose run comes first runs LPA on its forward graph's
    pattern, whose next launch then walks that order at once."""
    g = fix_transpose_vals(community_graph())
    gt = on_transpose(g, g.vals)
    walk_t = engaged(gt, order_of=g)
    walk = sp.row_walk(g, 64)
    assert walk is not None and len(lpa_runs) == 1
    assert torch.equal(walk_t.row_map, walk.row_map)


def test_backward_products_name_their_forward_graph(monkeypatch):
    """spmm_transposed launches kernel B over the transpose with the
    forward graph as the source of its order."""
    g = fix_transpose_vals(community_graph())
    seen = []

    def spy(graph, x, dense=None, *, order_of=None):
        seen.append((graph, order_of))
        return sp.spmm_segment(graph, x, dense, order_of=order_of)

    monkeypatch.setattr(ag, "spmm_segment", spy)
    x = torch.randn(N, 4, generator=torch.Generator().manual_seed(3))
    out = ag.spmm_transposed(g, g.vals, x)
    assert len(seen) == 1 and seen[0][1] is g
    assert seen[0][0] is on_transpose(g, g.vals)
    assert torch.equal(out, sp.spmm_segment_plain(seen[0][0], x))


def test_block_share_reads_the_positions_it_is_given(monkeypatch):
    rows = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    cols = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    monkeypatch.setattr(sp, "ORDER_BLOCK", 2)
    assert sp.block_share(rows, cols) == 0.5
    assert sp.block_share(rows, cols, torch.tensor([0, 2, 1, 3])) == 0.0
    monkeypatch.setattr(sp, "ORDER_BLOCK", 4)
    assert sp.block_share(rows, cols) == 1.0
