"""Kernel B's row order, on the CPU: the walk a prepared operator
carries (``sgc_tpu_torch/ops/autograd.py::prepare_operator``, its order
from ``graph/reorder.py::walk_order``), the permuted CSR and row map
that kernel B's launcher (``ops/spmm.py::_spmm_segment_cuda``) hands to
``csrc/spmm_csr.cu``, and the rule that decides, at launch, whether a
product walks it.

The kernel walks the permuted CSR's row r and writes the graph's row
``row_map[r]``; each row's edges stay in their ``row_ptr`` order, so its
sum is the same chain and the product keeps its bits. Here the plain
version of a row-mapped product (``spmm_walk_plain``) is held to
``spmm_segment_plain`` bit for bit; the card tests hold the kernel to
the same (tests/test_torch_port_row_order_cuda.py).

The launcher runs here with its kernel replaced by ``spmm_walk_plain``
(the ``launches`` fixture), which records what each launch walks. The
graphs are small (a few thousand nodes), so the tests set the L2 size
(0 bytes unless a test says otherwise) and shrink the measure's block
to the graphs' scale.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from sgc_tpu_torch.graph import reorder
from sgc_tpu_torch.graph.sparse import RowWalk, SparseGraph
from sgc_tpu_torch.ops import autograd as ag
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops import spmm as sp
from sgc_tpu_torch.ops.autograd import on_transpose, prepare_operator
from sgc_tpu_torch.utils import profiling
from sgc_tpu_torch.utils.buildcache import HostBuildCache

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


@pytest.fixture(autouse=True)
def small_scale(monkeypatch):
    """A block at the small graphs' scale (a few blocks a community, as
    ORDER_BLOCK is to the Reddit shape's), and an L2 of 0 bytes."""
    monkeypatch.setattr(reorder, "ORDER_BLOCK", 200)
    monkeypatch.setattr(sp, "l2_bytes", lambda device: 0)


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


@pytest.fixture
def launches(monkeypatch):
    """Kernel B's launcher on CPU tensors: the kernel is
    ``spmm_walk_plain`` over what the launcher hands it, and each launch
    is recorded as the RowWalk it walked (``row_map`` None in index
    order). Backward products (``ops.autograd``) take the launcher too."""
    seen = []

    def launch(row_ptr, cols, vals, x, dense, out, x_bf16=False, lib=None,
               plan=None, cta_order=None, row_map=None):
        seen.append(RowWalk(row_ptr, cols, vals, row_map))
        ident = torch.arange(out.shape[0], dtype=torch.int32)
        out.copy_(spmm_walk_plain(RowWalk(
            row_ptr, cols, vals, ident if row_map is None else row_map),
            x, dense))

    monkeypatch.setattr(kernels, "require_cuda_f32", lambda *a, **k: None)
    monkeypatch.setattr(sp, "launch_csr", launch)
    monkeypatch.setattr(ag, "spmm_segment", lambda graph, x, dense=None:
                        sp._spmm_segment_cuda(graph, x, dense))
    return seen


def run(graph, F=64, dense=None, seed=0):
    """One launch of kernel B's launcher on ``graph`` at width F."""
    x = torch.randn(graph.n_cols, F,
                    generator=torch.Generator().manual_seed(seed))
    return sp._spmm_segment_cuda(graph, x, dense), x


def walked(launch, walk):
    """Whether ``launch`` walked exactly ``walk``'s arrays."""
    return all(getattr(launch, k) is getattr(walk, k)
               for k in ("row_ptr", "cols", "vals", "row_map"))


def in_index_order(launch, graph):
    return (launch.row_map is None and launch.row_ptr is graph.row_ptr
            and launch.cols is graph.cols and launch.vals is graph.vals)


def test_walk_keeps_each_rows_edges_in_order_and_maps_a_permutation():
    g = community_graph()
    order = torch.as_tensor(np.random.default_rng(1).permutation(N))
    walk = sp.walk_rows(g, order)
    assert walk.row_map.dtype == torch.int32
    assert walk.row_ptr.dtype == torch.int32
    assert torch.equal(torch.sort(walk.row_map.long()).values,
                       torch.arange(N))
    assert int(walk.row_ptr[-1]) == g.nnz == walk.cols.numel()
    assert walk.vals.numel() == g.nnz
    gp, ptr = g.row_ptr.long(), walk.row_ptr
    for r in range(N):
        src = int(walk.row_map[r])
        lo, hi = int(ptr[r]), int(ptr[r + 1])
        assert torch.equal(walk.cols[lo:hi], g.cols[gp[src]:gp[src + 1]])
        assert torch.equal(walk.vals[lo:hi], g.vals[gp[src]:gp[src + 1]])


@pytest.mark.parametrize("with_dense", [False, True])
@pytest.mark.parametrize("F", [1, 8, 64])
def test_row_mapped_product_has_the_plain_products_bits(F, with_dense):
    g = prepare_operator(community_graph())
    assert g.walk is not None
    gen = torch.Generator().manual_seed(F)
    x = torch.randn(N, F, generator=gen)
    dense = torch.randn(N, F, generator=gen) if with_dense else None
    assert torch.equal(spmm_walk_plain(g.walk, x, dense),
                       sp.spmm_segment_plain(g, x, dense))


def test_lpa_order_engages_on_a_shuffled_graph(lpa_runs):
    g = community_graph()
    nnz = g.nnz
    assert (reorder.block_share(g.rows[:nnz], g.cols[:nnz])
            < reorder.ORDER_LOCAL_SHARE)
    assert reorder.walk_order(g) is not None
    assert prepare_operator(g).walk is not None
    assert len(lpa_runs) == 2


@pytest.mark.parametrize("F", [1, 8, 64])
def test_bypass_where_the_table_fits_the_l2(lpa_runs, launches,
                                           monkeypatch, F):
    """A table of n x F f32 within the L2 keeps index order, however
    many launches: the prepared walk is not launched; a wider product on
    the same operator walks it."""
    g = prepare_operator(community_graph())
    monkeypatch.setattr(sp, "l2_bytes", lambda device: 4 * N * F)
    for _ in range(3 * 32):
        assert sp.row_walk(g, F) is None
    out, x = run(g, F)
    assert in_index_order(launches[-1], g)
    assert torch.equal(out, sp.spmm_segment_plain(g, x))
    assert sp.row_walk(g, F + 1) is g.walk
    run(g, F + 1)
    assert walked(launches[-1], g.walk)
    assert len(lpa_runs) == 1


def test_bypass_where_the_ids_are_already_local(lpa_runs):
    """A graph in community order (as the locality plan's LPA-ordered
    hops) reads local: no LPA run, no walk."""
    g = community_graph(shuffle=False)
    assert reorder.walk_order(g) is None
    prepared = prepare_operator(g)
    assert prepared.walk is None
    assert prepared.prepared_transpose.walk is None
    assert sp.row_walk(prepared, 64) is None
    assert lpa_runs == []


def test_bypass_where_lpa_finds_no_more_local_order(lpa_runs):
    """A graph with no communities: one LPA run at the preparation, whose
    order is no more local, so the operator carries no walk."""
    g = prepare_operator(uniform_graph())
    assert g.walk is None and g.prepared_transpose.walk is None
    for _ in range(3 * 32):
        assert sp.row_walk(g, 64) is None
    assert len(lpa_runs) == 1


def test_bypass_for_a_graph_that_is_not_square(lpa_runs):
    g = community_graph().row_subgraph(np.arange(0, N, 2)).to(
        torch.device("cpu"))
    assert g.n_rows != g.n_cols
    assert reorder.walk_order(g) is None
    prepared = prepare_operator(g)
    assert prepared.walk is None
    assert prepared.prepared_transpose.walk is None
    assert lpa_runs == []


@pytest.mark.parametrize("launches_a_run", [2, 16, 3 * 32])
def test_an_unprepared_graph_launches_in_index_order_however_long_its_run(
        lpa_runs, launches, launches_a_run):
    """A graph nobody prepared (a K-hop precompute's, a shallow model's,
    or a deep stack's whose caller did not prepare it) launches in index
    order however many launches come in a row on it, with other graphs'
    launches between the runs: no LPA run."""
    g, other = community_graph(), community_graph(seed=1)
    for _ in range(3):
        for _ in range(launches_a_run):
            run(g)
            assert in_index_order(launches[-1], g)
        run(other)
        assert in_index_order(launches[-1], other)
    assert lpa_runs == []


def test_one_preparation_one_lpa_run_every_launch_reuses_the_walk(
        lpa_runs, launches):
    g = prepare_operator(community_graph())
    assert len(lpa_runs) == 1 and g.walk is not None
    names = ("launch.csr_spmm", "within.csr_spmm_ordered")
    before = profiling.read_counts(names)
    for _ in range(50):
        run(g)
        assert walked(launches[-1], g.walk)
        # SpmmSegmentFn re-wraps the graph with its own values
        run(g.with_vals(g.vals))
        assert walked(launches[-1], g.walk)
    # the order holds whatever runs come between
    other = community_graph(seed=1)
    run(other)
    assert in_index_order(launches[-1], other)
    run(g)
    assert walked(launches[-1], g.walk)
    assert len(lpa_runs) == 1
    got = {k: v - before[k] for k, v in profiling.read_counts(names).items()}
    assert got == {"launch.csr_spmm": 102, "within.csr_spmm_ordered": 101}


def test_the_walk_lives_and_dies_with_its_operator(lpa_runs):
    """The walks are held by the operator and its transpose alone: once
    the prepared graph is dropped they are freed, and preparing graphs
    grows no module-level container of the launch path."""
    modules = (sp, ag, reorder)

    def sizes():
        return {(m.__name__, k): len(v) for m in modules
                for k, v in vars(m).items()
                if isinstance(v, (dict, list, set, HostBuildCache))}

    start = sizes()
    refs = []
    for seed in range(3):
        g = prepare_operator(community_graph(seed=seed))
        for w in (g.walk, g.prepared_transpose.walk):
            refs += [weakref.ref(getattr(w, k))
                     for k in ("row_ptr", "cols", "vals", "row_map")]
        del g, w
    gc.collect()
    assert len(refs) == 24 and all(r() is None for r in refs)
    assert sizes() == start
    assert len(lpa_runs) == 3


def test_with_vals_of_other_values_drops_the_walk_and_gives_the_plain_bits(
        launches):
    """GAT's reweightings share the row pointers and columns and bring
    new values each step: a prepared operator given other values is a
    plain graph again, launched in index order, its transpose gathered;
    its product has the plain product's bits."""
    g = prepare_operator(community_graph())
    for step in range(3):
        vals = torch.randn(g.vals.shape,
                           generator=torch.Generator().manual_seed(step))
        gv = g.with_vals(vals)
        assert gv.walk is None and gv.prepared_transpose is None
        out, x = run(gv, 8)
        assert in_index_order(launches[-1], gv)
        assert torch.equal(out, sp.spmm_segment_plain(gv, x))
        assert on_transpose(gv, vals) is not g.prepared_transpose
    # the other constructors drop the preparation too
    assert g.to(torch.device("cpu")).walk is None
    assert g.transpose().walk is None
    assert g.row_subgraph(np.arange(10)).walk is None


def test_the_prepared_transpose_walks_the_forwards_permutation(lpa_runs):
    """The prepared transpose carries the operator's values and its own
    walk, in the forward's node order: one LPA run for both."""
    g = prepare_operator(community_graph())
    gt = on_transpose(g, g.vals)
    assert gt is g.prepared_transpose
    assert gt.walk is not None and len(lpa_runs) == 1
    assert torch.equal(gt.walk.row_map, g.walk.row_map)
    gt_plain, perm = ag.transposed(g)
    want = torch.zeros_like(g.vals)
    want[:g.nnz] = g.vals[perm]
    assert torch.equal(gt.vals, want)
    x = torch.randn(N, 8, generator=torch.Generator().manual_seed(9))
    assert torch.equal(spmm_walk_plain(gt.walk, x),
                       sp.spmm_segment_plain(gt_plain.with_vals(want), x))


def test_a_backward_launched_before_any_forward_walks_the_same_order(
        lpa_runs, launches):
    """A transpose launched first walks its prepared order at once, and
    the forward launched after it walks the same node order."""
    g = prepare_operator(community_graph())
    x = torch.randn(N, 64, generator=torch.Generator().manual_seed(4))
    ag.spmm_transposed(g, g.vals, x)
    assert walked(launches[-1], g.prepared_transpose.walk)
    run(g)
    assert walked(launches[-1], g.walk)
    assert torch.equal(launches[0].row_map, launches[1].row_map)
    assert len(lpa_runs) == 1


def test_spmm_transposed_launches_the_prepared_transpose_and_its_walk(
        monkeypatch):
    """spmm_transposed launches kernel B over the prepared transpose,
    which carries its walk; no order is passed beside the graph."""
    g = prepare_operator(community_graph())
    seen = []

    def spy(graph, x, dense=None):
        seen.append(graph)
        return sp.spmm_segment(graph, x, dense)

    monkeypatch.setattr(ag, "spmm_segment", spy)
    x = torch.randn(N, 4, generator=torch.Generator().manual_seed(3))
    out = ag.spmm_transposed(g, g.vals, x)
    assert len(seen) == 1 and seen[0] is g.prepared_transpose
    assert sp.row_walk(seen[0], 64) is seen[0].walk is not None
    assert torch.equal(out, sp.spmm_segment_plain(seen[0], x))


def test_the_same_graph_at_the_same_F_gives_the_same_launch_whatever_ran_before(
        launches):
    """Nothing a process launched before decides a launch's row order:
    a prepared operator walks its order from its first launch on, an
    unprepared graph stays in index order, at every point of any history
    of launches on other graphs, on the transpose and at other widths."""
    g = prepare_operator(community_graph())
    plain = community_graph(seed=1)
    run(g)
    first = launches[-1]
    run(plain)
    first_plain = launches[-1]
    for _ in range(40):
        run(plain)
    for _ in range(40):
        run(g, 8)
    ag.spmm_transposed(g, g.vals, torch.ones(N, 64))
    run(g.with_vals(g.vals * 2))
    run(g)
    run(plain)
    assert walked(first, g.walk) and walked(launches[-2], g.walk)
    assert in_index_order(first_plain, plain)
    assert in_index_order(launches[-1], plain)


def test_block_share_reads_the_positions_it_is_given(monkeypatch):
    rows = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    cols = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    monkeypatch.setattr(reorder, "ORDER_BLOCK", 2)
    assert reorder.block_share(rows, cols) == 0.5
    assert reorder.block_share(rows, cols, torch.tensor([0, 2, 1, 3])) == 0.0
    monkeypatch.setattr(reorder, "ORDER_BLOCK", 4)
    assert reorder.block_share(rows, cols) == 1.0
