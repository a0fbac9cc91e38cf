"""The CUDA kernels (A: block-dense cells, B: CSR remainder, C: tiled
SpMM, D: SDDMM) against their plain PyTorch versions, on the card, on
ragged cases; each kernel's test also checks that two launches give
identical bits.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). The file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: rtol = atol = 1e-5 relative to max|plain|, since kernel and
plain version differ only in the order of the f32 sums. Kernel A at
``precision="bf16"`` is held against the plain version on bf16-rounded
x; at ``"f32"`` against the plain f32 product (its two bf16 terms of x
leave at most 2**-16 |x|). Kernels C and D at ``"bf16"`` are held
against their plain versions at ``"bf16"``, which round the same values
to bf16 (x and each slot's product for C, the operand rows for D).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.ops import spmm as port_spmm
from sgc_tpu_torch.ops import spmm_blockdense as port_bd

TOL = 1e-5


def assert_close_rel(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max relative error {err:.3e} > {tol}"


def community_coo(seed, n, block, n_dense_blocks, per_block, n_sparse):
    """Edges concentrated in a few diagonal cells plus a sparse tail."""
    rng = np.random.default_rng(seed)
    r, c = [], []
    for b in rng.choice(n // block, n_dense_blocks, replace=False):
        r.append(b * block + rng.integers(0, block, per_block))
        c.append(b * block + rng.integers(0, block, per_block))
    r.append(rng.integers(0, n, n_sparse))
    c.append(rng.integers(0, n, n_sparse))
    rows, cols = np.concatenate(r), np.concatenate(c)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _main_path_like_split(super_rows, group_cells=None):
    n, f = 1300, 602      # ragged row blocks and feature tiles
    rows, cols, vals = community_coo(6, n, 512, 2, 30000, 20000)
    pg = PortGraph.from_coo(rows, cols, vals, n, n)
    split = port_bd.split_block_dense(pg, f, min_edges=5000.0,
                                      super_rows=super_rows,
                                      group_cells=group_cells)
    x = np.random.default_rng(7).standard_normal((n, f)).astype(np.float32)
    return split, torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("super_rows", [None, 8])
def test_cuda_dense_term_matches_plain(cuda, super_rows):
    split, x = _main_path_like_split(super_rows)
    args = port_bd.blockdense_device_args(split, cuda)
    xd = x.to(cuda)
    before = port_bd.LAUNCHES
    got = port_bd.apply_cells(split, args, xd)
    again = port_bd.apply_cells(split, args, xd)
    assert port_bd.LAUNCHES == before + 2
    want = port_bd.apply_cells_plain(split, args, xd)
    torch.cuda.synchronize()
    assert torch.equal(got, again)          # deterministic
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())
    # row blocks without cells are zero
    idle = sorted(set(range(split.n_row_blocks)) - set(split.rb_ids.tolist()))
    for rb in idle:
        assert not got[rb * 512:(rb + 1) * 512].any()


@pytest.mark.cuda
@pytest.mark.parametrize("super_rows,group_cells", [(None, None), (8, None),
                                                    (8, 4)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_dense_term_precision_matches_plain(cuda, precision, super_rows,
                                                 group_cells):
    """Kernel A at each precision, in both index orders and the grouped
    layout (zero hole cells): two launches give identical bits, row blocks
    without cells are zero, and the result holds the plain version."""
    split, x = _main_path_like_split(super_rows, group_cells)
    if group_cells is not None:
        assert split.n_slots > split.n_cells         # holes in the index
    args = port_bd.blockdense_device_args(split, cuda)
    xd = x.to(cuda)
    before = port_bd.LAUNCHES
    got = port_bd.apply_cells(split, args, xd, precision)
    again = port_bd.apply_cells(split, args, xd, precision)
    assert port_bd.LAUNCHES == before + 2
    want = port_bd.apply_cells_plain(split, args, xd, precision)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())
    idle = sorted(set(range(split.n_row_blocks)) - set(split.rb_ids.tolist()))
    assert idle
    for rb in idle:
        assert not got[rb * 512:(rb + 1) * 512].any()
    if precision == "f32":   # the bf16 mode is a different function
        coarse = port_bd.apply_cells_plain(split, args, xd, "bf16")
        err = float((coarse - want).abs().max()) / float(want.abs().max())
        assert err > 100 * TOL


@pytest.mark.cuda
def test_cuda_remainder_matches_plain(cuda):
    split, x = _main_path_like_split(8)
    args = port_bd.blockdense_device_args(split, cuda)
    xd = x.to(cuda)
    dense = torch.randn(split.n_rows, x.shape[1], device=cuda)
    before = port_spmm.LAUNCHES
    got = port_spmm.spmm_segment(args.rest, xd, dense)
    again = port_spmm.spmm_segment(args.rest, xd, dense)
    assert port_spmm.LAUNCHES == before + 2
    want = port_spmm.spmm_segment_plain(args.rest, xd, dense)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("f,offset", [(33, 0), (602, 1)])
def test_cuda_remainder_scalar_path_matches_plain(cuda, f, offset):
    """Kernel B's scalar path: an odd feature count, and an even one whose
    x starts 4 bytes past an 8-byte boundary (no float2 loads)."""
    rows, cols, vals = community_coo(8, 900, 128, 2, 4000, 6000)
    g = PortGraph.from_coo(rows, cols, vals, 900, 900).to(cuda)
    buf = torch.randn(900 * f + offset, device=cuda)
    xd = buf[offset:].view(900, f)
    dense = torch.randn(900, f, device=cuda)
    got = port_spmm.spmm_segment(g, xd, dense)
    assert torch.equal(got, port_spmm.spmm_segment(g, xd, dense))
    want = port_spmm.spmm_segment_plain(g, xd, dense)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_blockdense_op_and_capability(cuda):
    from sgc_tpu_torch.ops.capability import require_cuda_kernels

    assert require_cuda_kernels(cuda).type == "cuda"
    split, x = _main_path_like_split(8)
    xd = x.to(cuda)
    got = port_bd.spmm_blockdense(split, xd)
    want = port_bd.spmm_block_dense(split, xd)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


# --------------------------------------------------------------- kernel C

def _tiled_case(n_rows, n_cols, f, R, W, C, seed, dense=True, n_edges=30000):
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled

    rng = np.random.default_rng(seed)
    if dense:   # most edges in a few cells, so chunks fill and pad
        rows = np.concatenate([rng.integers(0, min(R, n_rows), n_edges),
                               rng.integers(0, n_rows, n_edges // 10)])
        cols = np.concatenate([rng.integers(0, min(W, n_cols), n_edges),
                               rng.integers(0, n_cols, n_edges // 10)])
    else:
        rows = rng.integers(0, n_rows, n_edges)
        cols = rng.integers(0, n_cols, n_edges)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    g = PortGraph.from_coo(rows, cols, vals, n_rows, n_cols)
    tiled = port_tiled.tile_graph(g, R, W, C)
    x = rng.standard_normal((n_cols, f)).astype(np.float32)
    return g, tiled, torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["flat", "stripes"])
@pytest.mark.parametrize("n_rows,n_cols,f,R,W,C", [
    (1300, 1300, 602, 512, 512, 1024),    # ragged F, short last stripe
    (700, 1900, 45, 512, 512, 1024),      # rectangular operator
    (3000, 3000, 70, 2048, 2048, 1024),   # row tiles, unstaged stripes
    (900, 900, 33, 256, 128, 2048),       # chunks of two pieces
    (600, 600, 16, 64, 64, 16),           # small cells and chunks
])
def test_cuda_tiled_spmm_matches_plain(cuda, entry, n_rows, n_cols, f, R,
                                       W, C):
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled

    g, tiled, x = _tiled_case(n_rows, n_cols, f, R, W, C, seed=R + C)
    args = port_tiled.tiled_device_args(tiled, cuda)
    xd = x.to(cuda)
    fn = (port_tiled.spmm_tiled_flat if entry == "flat"
          else port_tiled.spmm_tiled_stripes)
    before = port_tiled.LAUNCHES
    got = fn(tiled, xd, args)
    again = fn(tiled, xd, args)
    assert port_tiled.LAUNCHES == before + 2
    want = port_tiled.spmm_tiled_plain(tiled, xd)
    torch.cuda.synchronize()
    assert torch.equal(got, again)          # deterministic
    assert got.shape == (n_rows, f)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())
    # the layout's product is the graph's product
    assert_close_rel(got.cpu().numpy(),
                     port_spmm.spmm_segment_plain(g.to("cpu"), x).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("index", ["native", "plain"])
def test_cuda_tiled_spmm_index_paths(cuda, index):
    """Kernel C from the native row index and from its numpy twin, on
    rows that straddle 16-slot chunks and an odd feature count (the
    scalar-load path): the same bits either way, and the plain product."""
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled

    g, tiled, x = _tiled_case(900, 900, 33, 256, 128, 16, seed=5)
    build = (port_tiled.row_index if index == "native"
             else port_tiled.row_index_plain)
    args = port_tiled.tiled_device_args(
        tiled, cuda, port_tiled.row_csr(tiled, build(tiled)))
    other = port_tiled.tiled_device_args(tiled, cuda)
    xd = x.to(cuda)
    got = port_tiled.spmm_tiled_flat(tiled, xd, args)
    assert torch.equal(got, port_tiled.spmm_tiled_stripes(tiled, xd, other))
    want = port_tiled.spmm_tiled_plain(tiled, xd)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_tiled_spmm_empty_graph_and_row_blocks(cuda):
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled

    empty = PortGraph.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               np.zeros(0, np.float32), 700, 700)
    tiled = port_tiled.tile_graph(empty, 512, 512, 1024)
    x = torch.randn(700, 40, device=cuda)
    before = port_tiled.LAUNCHES
    out = port_tiled.spmm_tiled_flat(tiled, x)
    assert port_tiled.LAUNCHES == before       # no launch for no edges
    assert out.shape == (700, 40) and not out.any()
    # edges only in the first row block: the others come back zero
    rng = np.random.default_rng(3)
    g = PortGraph.from_coo(rng.integers(0, 100, 900),
                           rng.integers(0, 1500, 900),
                           rng.random(900).astype(np.float32), 1500, 1500)
    tiled = port_tiled.tile_graph(g, 512, 512, 64)
    out = port_tiled.spmm_tiled_flat(tiled, torch.randn(1500, 40,
                                                        device=cuda))
    assert out[:100].any() and not out[100:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("min_fill", [0.5, 2.0])   # 2.0: no dense part
def test_cuda_hybrid_split_matches_segment(cuda, min_fill):
    from sgc_tpu_torch.ops import spmm_hybrid as port_hybrid
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled

    g, _, x = _tiled_case(1300, 1300, 602, 512, 512, 1024, seed=11)
    split = port_hybrid.split_dense_cells(g, 602, 512, 512, 1024,
                                          min_fill=min_fill)
    assert (split.tiled is None) == (min_fill > 1)
    xd = x.to(cuda)
    before = (port_tiled.LAUNCHES, port_spmm.LAUNCHES)
    got = port_hybrid.spmm_hybrid_split(split, xd)
    assert port_spmm.LAUNCHES == before[1] + 1
    assert port_tiled.LAUNCHES == before[0] + (split.tiled is not None)
    want = port_spmm.spmm_segment(g.to(cuda), xd)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


# --------------------------------------------------------------- kernel D

@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,n_cols,f", [(1000, 1000, 602),
                                             (48, 80, 16), (300, 50, 33)])
def test_cuda_sddmm_matches_plain(cuda, n_rows, n_cols, f):
    rng = np.random.default_rng(n_rows + f)
    e = 5000
    vals = rng.random(e).astype(np.float32)
    vals[:50] = 0.0                       # genuine zero-weight edges
    g = PortGraph.from_coo(rng.integers(0, n_rows, e),
                           rng.integers(0, n_cols, e), vals, n_rows,
                           n_cols).to(cuda)
    a = torch.from_numpy(
        rng.standard_normal((n_rows, f)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(
        rng.standard_normal((n_cols, f)).astype(np.float32)).to(cuda)
    before = port_spmm.SDDMM_LAUNCHES
    got = port_spmm.sddmm(g, a, b)
    again = port_spmm.sddmm(g, a, b)
    assert port_spmm.SDDMM_LAUNCHES == before + 2
    want = port_spmm.sddmm_plain(g, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.shape == (g.n_edges_padded,)
    assert not got[g.nnz:].any()          # padding slots exactly 0
    zero_w = (g.vals[: g.nnz] == 0).nonzero().flatten()
    assert len(zero_w) and got[zero_w].abs().min() > 0
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [602, 33])
@pytest.mark.parametrize("entry", ["flat", "stripes"])
def test_cuda_tiled_spmm_bf16_matches_plain(cuda, entry, f):
    """Kernel C at precision "bf16" through both entries (float2 and scalar
    loads of the bf16 x): the plain version at "bf16", identical bits
    across two launches, and a different function from "f32"."""
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled

    _, tiled, x = _tiled_case(1300, 1300, f, 512, 512, 1024, seed=f)
    args = port_tiled.tiled_device_args(tiled, cuda)
    xd = x.to(cuda)
    fn = (port_tiled.spmm_tiled_flat if entry == "flat"
          else port_tiled.spmm_tiled_stripes)
    before = port_tiled.LAUNCHES
    got = fn(tiled, xd, args, "bf16")
    again = fn(tiled, xd, args, "bf16")
    assert port_tiled.LAUNCHES == before + 2
    want = port_tiled.spmm_tiled_plain(tiled, xd, "bf16")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())
    f32 = port_tiled.spmm_tiled_plain(tiled, xd, "f32")
    err = float((f32 - want).abs().max()) / float(want.abs().max())
    assert err > 100 * TOL


@pytest.mark.cuda
def test_cuda_hybrid_split_bf16_matches_plain(cuda):
    from sgc_tpu_torch.ops import spmm_hybrid as port_hybrid

    g, _, x = _tiled_case(1300, 1300, 602, 512, 512, 1024, seed=12)
    split = port_hybrid.split_dense_cells(g, 602, 512, 512, 1024,
                                          min_fill=0.5)
    assert split.tiled is not None and split.rest is not None
    got = port_hybrid.spmm_hybrid_split(split, x.to(cuda), precision="bf16")
    want = port_hybrid.spmm_hybrid_split(split, x, precision="bf16")
    assert_close_rel(got.cpu().numpy(), want.numpy())


def _sddmm_case(kind, n_rows, n_cols, f, seed):
    """Edges for kernel D: "hubs" gives a few rows thousands of edges
    (each cut into many warp segments), "short" spreads edges uniformly
    (rows of a few edges, several rows a segment), "both" does both."""
    rng = np.random.default_rng(seed)
    r, c = [], []
    if kind in ("hubs", "both"):
        for hub in rng.choice(n_rows, 3, replace=False):
            r.append(np.full(3000, hub))
            c.append(rng.integers(0, n_cols, 3000))
    if kind in ("short", "both"):
        r.append(rng.integers(0, n_rows, 4000))
        c.append(rng.integers(0, n_cols, 4000))
    rows, cols = np.concatenate(r), np.concatenate(c)
    vals = rng.random(len(rows)).astype(np.float32)
    vals[:40] = 0.0                       # genuine zero-weight edges
    g = PortGraph.from_coo(rows, cols, vals, n_rows, n_cols)
    a = rng.standard_normal((n_rows, f)).astype(np.float32)
    b = rng.standard_normal((n_cols, f)).astype(np.float32)
    return g, torch.from_numpy(a), torch.from_numpy(b)


def _check_sddmm(g, got, again, want):
    torch.cuda.synchronize()
    assert torch.equal(got, again)          # deterministic
    assert got.shape == (g.n_edges_padded,)
    assert not got[g.nnz:].any()            # padding slots exactly 0
    zero_w = (g.vals[: g.nnz] == 0).nonzero().flatten()
    assert len(zero_w) and got[zero_w].abs().min() > 0
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind,n_rows,n_cols,f", [
    ("hubs", 1300, 1300, 602),     # long rows cut into segments
    ("short", 3000, 2000, 602),    # rectangular, several rows a segment
    ("both", 1300, 1100, 64),
    ("both", 1300, 1300, 33),      # odd F: scalar loads of a (and b at f32)
    ("both", 1100, 1600, 7),       # F under one lane's vector
    ("both", 1300, 1300, 1300),    # two passes over the features
])
def test_cuda_sddmm_precisions_match_plain(cuda, precision, kind, n_rows,
                                           n_cols, f):
    """Kernel D at both precisions through the entry point ``sddmm``."""
    g, a, b = _sddmm_case(kind, n_rows, n_cols, f, seed=n_rows + f)
    g = g.to(cuda)
    a, b = a.to(cuda), b.to(cuda)
    before = port_spmm.SDDMM_LAUNCHES
    got = port_spmm.sddmm(g, a, b, precision)
    again = port_spmm.sddmm(g, a, b, precision)
    assert port_spmm.SDDMM_LAUNCHES == before + 2
    _check_sddmm(g, got, again, port_spmm.sddmm_plain(g, a, b, precision))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cuda_sddmm_misaligned_a_matches_plain(cuda, precision):
    """An f32 ``a`` whose rows are only 4-byte aligned takes the scalar
    loads of a."""
    g, _, b = _sddmm_case("both", 1300, 1100, 46, seed=3)
    buf = torch.randn(1300 * 46 + 1, device=cuda)
    a = buf[1:].view(1300, 46)
    g, b = g.to(cuda), b.to(cuda)
    got = port_spmm.sddmm(g, a, b, precision)
    again = port_spmm.sddmm(g, a, b, precision)
    _check_sddmm(g, got, again, port_spmm.sddmm_plain(g, a, b, precision))


@pytest.mark.cuda
def test_cuda_sddmm_any_edge_order_matches_plain(cuda):
    """The kernel finds each run of one row itself, so an edge list out of
    row order gives the same sums (it only reloads a's rows more often)."""
    g, a, b = _sddmm_case("both", 1300, 1300, 602, seed=4)
    perm = np.random.default_rng(5).permutation(g.nnz)
    pad = np.arange(g.nnz, g.n_edges_padded)
    order = np.concatenate([perm, pad])
    shuffled = dataclasses.replace(g, rows=g.rows[order],
                                   cols=g.cols[order], vals=g.vals[order])
    shuffled, a, b = shuffled.to(cuda), a.to(cuda), b.to(cuda)
    got = port_spmm.sddmm(shuffled, a, b)
    want = port_spmm.sddmm(g.to(cuda), a, b)[torch.from_numpy(order).to(cuda)]
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


# ------------------------------------------- sgc_precompute, the new caller

def _precompute_case():
    """A normalized operator with dense diagonal cells and a sparse tail
    (both splits get cells and a remainder), x at F = 300."""
    import scipy.sparse as sp

    from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency

    n, f = 3000, 300
    rows, cols, _ = community_coo(12, n, 512, 4, 6000, 3000)
    adj = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                        shape=(n, n))
    s = aug_normalized_adjacency(adj + adj.T)
    x = np.random.default_rng(13).standard_normal((n, f)).astype(np.float32)
    idx = np.sort(np.random.default_rng(14).choice(n, 400, replace=False))
    return PortGraph.from_scipy(s), torch.from_numpy(x), idx


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["tiled", "hybrid", "blockdense"])
@pytest.mark.parametrize("out_rows", [False, True])
def test_cuda_sgc_precompute_impl_matches_segment(cuda, impl, out_rows):
    """Each host-layout impl of ``sgc_precompute`` reaches its kernels
    (counters) and agrees with kernel B's all-segment hops: at 1e-5 for
    ``tiled`` and ``hybrid``, at 1e-2 for ``blockdense`` (bf16 cells and,
    at its default precision, bf16 x); one ``blockdense`` hop is also held
    against its plain version on the CPU at 1e-5."""
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled
    from sgc_tpu_torch.ops.propagate import sgc_precompute

    g, x, idx = _precompute_case()
    gd, xd = g.to(cuda), x.to(cuda)
    rows = idx if out_rows else None
    want, _ = sgc_precompute(xd, gd, 2, impl="segment", out_rows=rows)
    mods = {"blockdense": port_bd, "tiled": port_tiled, "segment": port_spmm}
    before = {k: m.LAUNCHES for k, m in mods.items()}
    got, seconds = sgc_precompute(xd, gd, 2, impl=impl, out_rows=rows)
    torch.cuda.synchronize()
    launched = {k: m.LAUNCHES - before[k] for k, m in mods.items()}
    expect = {"tiled": ("tiled",), "hybrid": ("tiled", "segment"),
              "blockdense": ("blockdense", "segment")}[impl]
    assert all(launched[k] >= 1 for k in expect), launched
    assert seconds > 0
    tol = 1e-2 if impl == "blockdense" else TOL
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy(), tol)
    if impl == "blockdense":
        one, _ = sgc_precompute(xd, gd, 1, impl=impl, out_rows=rows)
        plain, _ = sgc_precompute(x, g.to("cpu"), 1, impl=impl,
                                  out_rows=rows)
        assert_close_rel(one.cpu().numpy(), plain.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [1, 2])
def test_cuda_sgc_precompute_out_rows_bit_equal(cuda, degree):
    """``out_rows`` through the row subgraph, which keeps each row's edges
    in order: kernel B sums them alike, so the rows are the same bits."""
    from sgc_tpu_torch.ops.propagate import sgc_precompute

    g, x, idx = _precompute_case()
    gd, xd = g.to(cuda), x.to(cuda)
    full, _ = sgc_precompute(xd, gd, degree)
    sub, _ = sgc_precompute(xd, gd, degree, out_rows=idx)
    assert torch.equal(sub, full[torch.as_tensor(idx, device=cuda)])


# ------------------------------- gradients through kernels B and D (GCN, GAT)

def _grad_case(n=1300, e=9000, f=40, seed=21):
    """A normalized operator (self-loops, rows of ragged length) and x."""
    import scipy.sparse as sp

    from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency

    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(e, np.float32),
                         (rng.integers(0, n, e), rng.integers(0, n, e))),
                        shape=(n, n))
    s = aug_normalized_adjacency(adj + adj.T)
    x = rng.standard_normal((n, f)).astype(np.float32)
    return PortGraph.from_scipy(s), torch.from_numpy(x)


def _grads(fn, params):
    """The loss and every parameter's gradient of one backward."""
    for p in params:
        p.grad = None
    loss = fn()
    loss.backward()
    return [loss.detach()] + [p.grad.clone() for p in params]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 8, 16, 602])
def test_cuda_spmm_segment_fn_backward_matches_cpu(cuda, f):
    """``SpmmSegmentFn``'s backward on the card: ``dx`` is kernel B over
    the transpose and ``dvals`` kernel D; both hold the CPU's plain
    versions at 1e-5 and repeat to the same bits."""
    from sgc_tpu_torch.ops import autograd as port_ag

    g, _ = _grad_case(f=f)
    x = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (g.n_cols, f)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(f + 1).standard_normal(
        (g.n_rows, f)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda):
        gd = g.to(dev)
        vals = gd.vals.clone().requires_grad_(True)
        xd = x.to(dev).requires_grad_(True)
        runs = []
        for _ in range(2):
            before = (port_spmm.SDDMM_LAUNCHES, port_ag.TRANSPOSED_LAUNCHES)
            out = port_ag.SpmmSegmentFn.apply(gd, vals, xd)
            dv, dx = torch.autograd.grad((out * w.to(dev)).sum(), (vals, xd))
            runs.append((dv, dx))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (port_spmm.SDDMM_LAUNCHES - before[0],
                    port_ag.TRANSPOSED_LAUNCHES - before[1]) == (1, 1)
            for a, b in zip(*runs):
                assert torch.equal(a, b)
        outs[str(dev)] = [t.cpu().numpy() for t in runs[0]]
    for a, b in zip(outs[str(cuda)], outs["cpu"]):
        assert_close_rel(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [0, 3])
def test_cuda_transposed_launches_count_launches_only(cuda, f):
    """The transposed count moves with kernel B's own: an empty product
    launches nothing and counts nothing."""
    from sgc_tpu_torch.ops import autograd as port_ag

    g, _ = _grad_case()
    gd = g.to(cuda)
    before = (port_spmm.LAUNCHES, port_ag.TRANSPOSED_LAUNCHES)
    out = port_ag.spmm_transposed(gd, gd.vals,
                                  torch.ones((g.n_rows, f), device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (g.n_cols, f)
    assert (port_spmm.LAUNCHES - before[0],
            port_ag.TRANSPOSED_LAUNCHES - before[1]) == (int(f > 0),) * 2


@pytest.mark.cuda
def test_cuda_gcn_and_deep_gcn_grads_match_cpu(cuda):
    """A GCN and a residual deep GCN on the card: the parameters'
    gradients hold the CPU's at 1e-4 and repeat to the same bits;
    ``remat`` on and off give the same bits."""
    from sgc_tpu_torch.models import deep_gcn, gcn

    g, x = _grad_case()
    y = torch.from_numpy(np.random.default_rng(22).integers(0, 5, g.n_rows))
    results = {}
    for dev in ("cpu", cuda):
        gd, xd, yd = g.to(dev), x.to(dev), y.to(dev)
        m = gcn.init_gcn(torch.Generator().manual_seed(0), 40, 16, 5,
                         device=dev)
        d = deep_gcn.init_deep_gcn(torch.Generator().manual_seed(1), 40, 32,
                                   5, n_layers=5, device=dev)
        mask = torch.rand((g.n_rows, 16),
                          generator=torch.Generator().manual_seed(2)) < 0.5
        runs = {
            "gcn": _grads(lambda: torch.nn.functional.cross_entropy(
                gcn.gcn_apply(m, xd, gd, dropout_rate=0.5,
                              keep_mask=mask.to(dev)), yd),
                list(m.parameters()))}
        for remat in (True, False):
            runs[f"deep_{remat}"] = _grads(
                lambda: torch.nn.functional.cross_entropy(
                    deep_gcn.deep_gcn_apply(d, xd, gd, remat=remat), yd),
                list(d.parameters()))
        if dev != "cpu":
            again = _grads(lambda: torch.nn.functional.cross_entropy(
                gcn.gcn_apply(m, xd, gd, dropout_rate=0.5,
                              keep_mask=mask.to(dev)), yd),
                list(m.parameters()))
            for a, b in zip(runs["gcn"], again):
                assert torch.equal(a, b)
            for a, b in zip(runs["deep_True"], runs["deep_False"]):
                assert torch.equal(a, b)
        results[str(dev)] = runs
    for name in ("gcn", "deep_True"):
        for a, b in zip(results[str(cuda)][name], results["cpu"][name]):
            assert_close_rel(a.cpu().numpy(), b.numpy(), 1e-4)


@pytest.mark.cuda
def test_cuda_gat_grads_match_cpu(cuda):
    """Two multi-head GAT layers (concat, then mean) on the card: the
    loss and the gradients hold the CPU's (1e-5 / 1e-4) and repeat to
    the same bits; the backward launched kernel D and the transposed
    kernel B."""
    from sgc_tpu_torch.models import gat
    from sgc_tpu_torch.ops import autograd as port_ag

    g, x = _grad_case(f=24)
    y = torch.from_numpy(np.random.default_rng(23).integers(0, 3, g.n_rows))
    results = {}
    for dev in ("cpu", cuda):
        gd, xd, yd = g.to(dev), x.to(dev), y.to(dev)
        l1 = gat.init_multi_head(torch.Generator().manual_seed(3), 4, 24, 8,
                                 device=dev)
        l2 = gat.init_multi_head(torch.Generator().manual_seed(4), 2, 32, 3,
                                 device=dev)
        params = list(l1.parameters()) + list(l2.parameters())

        def loss():
            h = gat.multi_head_gat(l1, xd, gd)
            return torch.nn.functional.cross_entropy(
                gat.multi_head_gat(l2, h, gd, concat=False, activation=None),
                yd)

        before = (port_spmm.SDDMM_LAUNCHES, port_ag.TRANSPOSED_LAUNCHES)
        results[str(dev)] = _grads(loss, params)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert port_spmm.SDDMM_LAUNCHES - before[0] == 6     # a head
            assert port_ag.TRANSPOSED_LAUNCHES - before[1] >= 12
            for a, b in zip(results[str(dev)], _grads(loss, params)):
                assert torch.equal(a, b)
    for a, b in zip(results[str(cuda)], results["cpu"]):
        assert_close_rel(a.cpu().numpy(), b.numpy(), 1e-4)


@pytest.mark.cuda
def test_cuda_degrees_match_cpu(cuda):
    """``degrees`` / ``binary_degrees``: kernel B with F = 1."""
    g, _ = _grad_case()
    before = port_spmm.LAUNCHES
    got = (g.to(cuda).degrees(), g.to(cuda).binary_degrees())
    assert port_spmm.LAUNCHES == before + 2
    assert_close_rel(got[0].cpu().numpy(), g.degrees().numpy())
    assert torch.equal(got[1].cpu(), g.binary_degrees())


# ------------------------- kernel B at every width class of its launch plan

B_WIDTHS = (1, 2, 3, 8, 16, 33, 41, 64, 602, 700)   # 700: two passes


@pytest.fixture(scope="module")
def width_graph():
    """5,000 rows (a multiple of no plan's rows per CTA) over 6,000
    columns: every 13th row empty, every 7th of 1-3 edges (shorter than
    any batch), the rest 4-40 edges, and row 7 a hub of 4,500 edges (more
    than a staged chunk holds)."""
    rng = np.random.default_rng(77)
    n_rows, n_cols = 5000, 6000
    deg = rng.integers(4, 41, n_rows)
    deg[1::7] = rng.integers(1, 4, deg[1::7].size)
    deg[::13] = 0
    deg[7] = 4500
    rows = np.repeat(np.arange(n_rows), deg)
    cols = rng.integers(0, n_cols, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return PortGraph.from_coo(rows, cols, vals, n_rows, n_cols)


# rows held against a row subgraph: the hub, empty and short rows, and
# rows at the ends and in the middle of CTAs
SUB_ROWS = np.array([0, 1, 7, 8, 13, 255, 256, 2500, 4991, 4999])


@pytest.mark.cuda
@pytest.mark.parametrize("with_dense", [False, True])
@pytest.mark.parametrize("offset", [0, 1])     # x aligned, x 4 bytes off
@pytest.mark.parametrize("f", B_WIDTHS)
def test_cuda_kernel_b_width_classes(cuda, width_graph, f, offset,
                                     with_dense):
    """Kernel B at every width class, with x aligned and 4 bytes off its
    alignment, with and without ``dense``: the plain version at 1e-5, the
    same bits over two launches, and each row the same bits as that row
    launched in a row subgraph (other neighbours, another position in its
    CTA and warp, another plan's rows per CTA)."""
    g = width_graph.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    buf = torch.randn(g.n_cols * f + offset, device=cuda, generator=gen)
    x = buf[offset:].view(g.n_cols, f)
    dense = (torch.randn(g.n_rows, f, device=cuda, generator=gen)
             if with_dense else None)
    before = port_spmm.LAUNCHES
    got = port_spmm.spmm_segment(g, x, dense)
    again = port_spmm.spmm_segment(g, x, dense)
    assert port_spmm.LAUNCHES == before + 2
    want = port_spmm.spmm_segment_plain(g, x, dense)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())
    sub = width_graph.row_subgraph(SUB_ROWS).to(cuda)
    idx = torch.as_tensor(SUB_ROWS, device=cuda)
    rows = port_spmm.spmm_segment(
        sub, x, None if dense is None else dense[idx].contiguous())
    assert torch.equal(rows, got[idx])
    assert not got[idx[4]].ne(0 if dense is None else dense[13]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 8, 41, 602])
def test_cuda_kernel_b_same_bits_for_any_plan(cuda, width_graph, f):
    """Any lanes per row changes which lane holds a feature, how many
    rows share a warp and CTA, the vectors per lane and the edges per
    batch, not the sum: every such plan gives the default plan's bits."""
    g = width_graph.to(cuda)
    x = torch.randn(g.n_cols, f, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    want = port_spmm.spmm_segment(g, x)
    align = port_spmm.operand_align(x, None, want)
    for lanes in (1, 2, 4, 8, 16, 32):
        plan = port_spmm.csr_plan(f, False, align, lanes=lanes)
        out = torch.empty_like(want)
        port_spmm.launch_csr(g.row_ptr, g.cols, g.vals, x, None, out,
                             plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(out, want), plan


@pytest.mark.cuda
def test_cuda_kernel_b_refuses_a_plan_it_does_not_compile(cuda, width_graph):
    g = width_graph.to(cuda)
    x = torch.randn(g.n_cols, 8, device=cuda)
    out = torch.empty(g.n_rows, 8, device=cuda)
    plan = port_spmm.csr_plan(8)
    for bad in (dataclasses.replace(plan, unroll=plan.unroll + 1),
                dataclasses.replace(plan, nv=4),
                dataclasses.replace(plan, rows_per_cta=7)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            port_spmm.launch_csr(g.row_ptr, g.cols, g.vals, x, None, out,
                                 plan=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 8, 41, 64, 602])
def test_cuda_kernel_c_bf16_width_classes(cuda, f):
    """Kernel C at "bf16" through the flat entry at each width class: the
    plain version at "bf16" (each slot's product rounded to bf16) at 1e-5
    and the same bits over two launches."""
    from sgc_tpu_torch.ops import spmm_tiled as port_tiled

    _, tiled, x = _tiled_case(1300, 1300, f, 512, 512, 1024, seed=f + 1)
    args = port_tiled.tiled_device_args(tiled, cuda)
    xd = x.to(cuda)
    got = port_tiled.spmm_tiled_flat(tiled, xd, args, "bf16")
    again = port_tiled.spmm_tiled_flat(tiled, xd, args, "bf16")
    want = port_tiled.spmm_tiled_plain(tiled, xd, "bf16")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


# ------------------------------------------------------------ the text path

# the chunk widths of COVID's phases (train 2048 x 3 + 482, val 736,
# test 1,825) and the passes of their plans
TEXT_WIDTHS = {2048: 4, 1825: 3, 736: 2, 482: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("with_dense", [False, True])
@pytest.mark.parametrize("f", sorted(TEXT_WIDTHS))
def test_cuda_kernel_b_text_widths(cuda, width_graph, f, with_dense):
    """Kernel B at the text path's chunk widths, its multi-pass plans: x a
    column chunk of a wider matrix made contiguous (as the structural
    precompute places its chunks), with and without the block-dense
    remainder's dense term; the plain version at 1e-5 and the same bits
    over two launches."""
    g = width_graph.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    wide = torch.randn(g.n_cols, f + 64, device=cuda, generator=gen)
    x = wide[:, 33:33 + f].contiguous()
    dense = (torch.randn(g.n_rows, f, device=cuda, generator=gen)
             if with_dense else None)
    plan = port_spmm.csr_plan(f, False, port_spmm.operand_align(x, dense))
    assert plan.passes == TEXT_WIDTHS[f]
    before = port_spmm.LAUNCHES
    got = port_spmm.spmm_segment(g, x, dense)
    again = port_spmm.spmm_segment(g, x, dense)
    assert port_spmm.LAUNCHES == before + 2
    want = port_spmm.spmm_segment_plain(g, x, dense)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())


@pytest.fixture(scope="module")
def text_corpus_graph(tmp_path_factory):
    """A doc-word graph from a seeded corpus (1,500 docs, 2,500 words)."""
    from sgc_tpu_torch.cli.build_graph import build_and_export
    from sgc_tpu_torch.data.fixtures import write_text_corpus

    root = tmp_path_factory.mktemp("text")
    info = write_text_corpus(root, "tiny", n_train=1200, n_test=300,
                             n_classes=8, vocab=2500, seed=5)
    build_and_export(str(info["metadata"]), str(info["corpus"]), "tiny",
                     str(root))
    return root


@pytest.mark.cuda
def test_cuda_text_structural_features(cuda, text_corpus_graph):
    """``text_structural_features`` on the card: ``sparse`` (kernel B, one
    launch a chunk) against ``dense`` at the reference's own bound (rtol
    2e-4, atol 2e-5), ``blockdense`` (kernel A + B) against ``sparse`` at
    the bf16-cell bound (2e-2 of max), and ``sparse`` against the CPU's
    run at 1e-5 of max."""
    from sgc_tpu_torch.data.textcorpus import load_corpus
    from sgc_tpu_torch.ops.propagate import text_structural_features
    from sgc_tpu_torch.utils.buildcache import clear_placed

    data = load_corpus("tiny", "BCD", str(text_corpus_graph), device=cuda)
    idx = data.index_dict
    feats, counts = {}, {}
    for impl in ("sparse", "blockdense", "dense"):
        b0, a0 = port_spmm.LAUNCHES, port_bd.LAUNCHES
        feats[impl], _ = text_structural_features(data.graph, idx, 2, impl)
        counts[impl] = (port_spmm.LAUNCHES - b0, port_bd.LAUNCHES - a0)
    clear_placed()
    assert counts["sparse"] == (3, 0)         # train 1,080, val, test
    assert counts["blockdense"][1] == 3 and counts["dense"] == (0, 0)
    cpu = load_corpus("tiny", "BCD", str(text_corpus_graph), device="cpu")
    on_cpu, _ = text_structural_features(cpu.graph, idx, 2, "sparse")
    for p in idx:
        s, d, b = (feats[k][p] for k in ("sparse", "dense", "blockdense"))
        torch.testing.assert_close(s, d, rtol=2e-4, atol=2e-5)
        assert float((b - s).abs().max()) <= 2e-2 * float(s.abs().max())
        assert_close_rel(s.cpu().numpy(), on_cpu[p].numpy())


# ---------------------------------------------------------------- serving

def _serve_problem(n=3000, f=24, c=5, e=30000, seed=11):
    """A Reddit-like normalized graph, raw and propagated features and a
    random head, all on the host."""
    import scipy.sparse as sp

    from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
    from sgc_tpu_torch.models.sgc import init_sgc

    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(e, np.float32),
                         ((rng.random(e) ** 2 * n).astype(np.int64),
                          rng.integers(0, n, e))), shape=(n, n))
    mat = aug_normalized_adjacency(adj + adj.T)
    x = rng.standard_normal((n, f)).astype(np.float32)
    store = (mat @ (mat @ x)).astype(np.float32)
    head = init_sgc(torch.Generator().manual_seed(seed), f, c, device="cpu")
    return PortGraph.from_scipy(mat), x, store, head


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "int8", "inductive"])
def test_cuda_engine_matches_its_cpu_run(cuda, mode):
    """Each engine mode on the card against the same engine on the CPU:
    transductive logits at 1e-5 of max; inductive on one sampled tree
    (drawn on the card, reduced on both devices) at 1e-5 of max, and the
    engine's call equal bit for bit to the head on that tree."""
    from sgc_tpu_torch.models.sgc import sgc_apply
    from sgc_tpu_torch.ops import sampling
    from sgc_tpu_torch.serve import EngineConfig, InferenceEngine

    graph, x, store, head = _serve_problem()
    ids = np.random.default_rng(0).integers(0, store.shape[0], 200)
    cfg = EngineConfig(max_batch=256, quantize_int8=(mode == "int8"),
                       fanouts=(25, 10), seed=3)
    if mode != "inductive":
        on_card = InferenceEngine(head, features=store, config=cfg,
                                  device=cuda)
        on_cpu = InferenceEngine(head, features=store, config=cfg,
                                 device="cpu")
        assert on_card._features.device.type == "cuda"
        assert_close_rel(on_card.predict_logits(ids),
                         on_cpu.predict_logits(ids))
        return
    cfg = EngineConfig(max_batch=256, fanouts=(25, 10), seed=3,
                       warmup=False)
    eng = InferenceEngine(head, graph=graph, raw_features=x, config=cfg,
                          device=cuda)
    got = eng.predict_logits(ids)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    padded = torch.zeros(256, dtype=torch.int32, device=cuda)
    padded[:200] = torch.as_tensor(ids, device=cuda)
    gd = graph.to(cuda)
    fr, ws = sampling.sample_tree(gd, padded, gen, (25, 10))
    est = sampling.reduce_tree(torch.as_tensor(x, device=cuda), fr, ws,
                               (25, 10))
    want = sgc_apply(eng.params, est)[:200].cpu().numpy()
    np.testing.assert_array_equal(got, want)
    est_cpu = sampling.reduce_tree(torch.from_numpy(x),
                                   [t.cpu() for t in fr],
                                   [t.cpu() for t in ws], (25, 10))
    assert_close_rel(est.cpu().numpy(), est_cpu.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_stream_equals_blocking(cuda, depth, int8):
    """The pinned-buffer stream against the blocking path, bit for bit,
    with every batch size and an empty batch in one stream."""
    from sgc_tpu_torch.serve import EngineConfig, InferenceEngine

    _, _, store, head = _serve_problem()
    eng = InferenceEngine(head, features=store, device=cuda,
                          config=EngineConfig(max_batch=1024,
                                              quantize_int8=int8))
    rng = np.random.default_rng(depth)
    batches = [rng.integers(0, store.shape[0], b)
               for b in (1, 1024, 7, 512, 64, 8, 1000, 3)] * 3
    batches.insert(5, [])
    blocking = [eng.predict_logits(b) for b in batches]
    streamed = list(eng.predict_logits_stream(batches, depth=depth))
    assert len(streamed) == len(blocking)
    for got, want in zip(streamed, blocking):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert len(eng._free) <= depth + 1


@pytest.mark.cuda
def test_cuda_offsets_in_range_at_a_hub_row(cuda):
    """A 23,980-edge row (the doc-word graph's largest): every draw on the
    card stays in [0, d), and every sampled neighbor is one of the row's."""
    from sgc_tpu_torch.ops import sampling

    d, n = 23_980, 30_000
    cols = np.sort(np.random.default_rng(1).choice(n, d, replace=False))
    rows = np.concatenate([np.zeros(d, np.int64), np.arange(1, n)])
    cols = np.concatenate([cols, np.arange(1, n)])
    vals = np.full(len(rows), 0.25, np.float32)
    g = PortGraph.from_coo(rows, cols, vals, n, n).to(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    degrees = torch.full((4096,), d, dtype=torch.int32, device=cuda)
    offs = torch.cat([sampling.draw_offsets(degrees, 256, gen)
                      for _ in range(4)])
    assert int(offs.min()) == 0 and int(offs.max()) <= d - 1
    assert int(offs.max()) >= d - 2
    nbr, w = sampling.sample_neighbors(
        g, torch.zeros(2048, dtype=torch.int32, device=cuda), gen, 64)
    torch.cuda.synchronize()
    assert bool(torch.isin(nbr.long(), torch.as_tensor(cols[:d],
                                                       device=cuda)).all())
    assert bool((w == 0.25 * d).all())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [100, 256])
def test_cuda_scatter_update_matches_plain(cuda, f):
    """Kernel B over ``scatter_graph`` (repeated ids, empty rows) against
    the plain version, the same bits twice, one launch each, at the main
    paths' shapes: word2vec's out-table update (F = 100, 49,152 Zipf ids
    into 14,832 words) and the transformer's embedding gradient (F = 256,
    32 front-padded docs of 256 into 30,000 ids: the PAD id's row of
    ~4,000 positions is the hub)."""
    rng = np.random.default_rng(f)
    if f == 100:
        n_words, n = 14_832, 49_152
        ids = np.minimum(rng.zipf(1.3, n), n_words) - 1
    else:
        n_words, n = 30_000, 32 * 256
        ids = np.minimum(rng.zipf(1.3, (32, 256)), n_words - 2) + 1
        for doc, length in zip(ids, rng.integers(20, 257, 32)):
            doc[:256 - length] = 0
        ids = ids.reshape(-1)
    ids = torch.from_numpy(ids).to(cuda)
    rows = torch.from_numpy(rng.standard_normal((n, f)).astype(
        np.float32)).to(cuda)
    table = torch.from_numpy(rng.standard_normal((n_words, f)).astype(
        np.float32)).to(cuda)
    g = port_spmm.scatter_graph(ids, n_words, -0.025)
    before = port_spmm.LAUNCHES
    got = port_spmm.spmm_segment(g, rows, dense=table)
    again = port_spmm.spmm_segment(g, rows, dense=table)
    torch.cuda.synchronize()
    assert port_spmm.LAUNCHES - before == 2
    assert torch.equal(got, again)
    want = port_spmm.spmm_segment_plain(g, rows, table)
    assert_close_rel(got.cpu(), want.cpu())
    cpu = port_spmm.scatter_graph(ids.cpu(), n_words, -0.025)
    for k in ("rows", "cols", "vals", "row_ptr"):
        assert torch.equal(getattr(g, k).cpu(), getattr(cpu, k)), k


@pytest.mark.cuda
def test_cuda_gather_rows_backward_repeats(cuda):
    from sgc_tpu_torch.ops.autograd import GatherRowsFn

    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((500, 64)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 500, (32, 128)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((32, 128, 64)).astype(
        np.float32))
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        t = table.to(dev).requires_grad_()
        GatherRowsFn.apply(t, ids.to(dev)).backward(g.to(dev))
        grads.append(t.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert_close_rel(grads[0], grads[2])


@pytest.mark.cuda
def test_cuda_word2vec_fit_repeats_and_matches_cpu(cuda):
    from sgc_tpu_torch.textgraph import word2vec as w2v

    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(300)]
    docs = [[words[j] for j in np.minimum(rng.zipf(1.4, 40), 300) - 1]
            for _ in range(200)]
    cfg = w2v.Word2VecConfig(dim=100, epochs=2, batch_size=1024, lr=0.002)
    a = w2v.Word2Vec(cfg, device=cuda).train(docs)
    b = w2v.Word2Vec(cfg, device=cuda).train(docs)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    assert np.isfinite(a.vectors).all()
    # one step on the card against the CPU on the same inputs
    in_emb = torch.from_numpy(a.vectors)
    out_emb = in_emb.flip(0).contiguous()
    pairs = torch.from_numpy(w2v.skipgram_pairs(docs, a.word_id, 5)[:1024])
    u = torch.rand((1024, 5), generator=torch.Generator().manual_seed(0))
    cdf = w2v.noise_cdf(w2v.build_vocab(docs)[2], "cpu")
    outs = [w2v.sgns_step(*(t.to(dev) for t in (in_emb, out_emb,
                                               pairs[:, 0], pairs[:, 1], u,
                                               cdf)), cfg.lr)
            for dev in (cuda, torch.device("cpu"))]
    for got, want in zip(outs[0][:2], outs[1][:2]):
        assert_close_rel(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_transformer_step_repeats_and_matches_cpu(cuda):
    """Three steps from one init give the same bits; the logits and the
    gradients agree with the CPU's to the bf16 recipe's bound (an f32
    sum-order difference can move a bf16 value one step, at most 2^-7 of
    it, so of the leaf's max; 1/8 of that again for the f32 leaves
    downstream of such a step)."""
    import copy

    from sgc_tpu_torch.models import transformer as tr
    from sgc_tpu_torch.train import sequence as seq

    cfg = tr.TransformerConfig(vocab_size=200, n_classes=5, max_len=32,
                               dim=64, n_heads=4, n_layers=2, dropout=0.1)
    init = tr.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 200, (8, 32)).astype(np.int32))
    mask = torch.ones((8, 32))
    mask[2] = 0.0                                   # an empty doc
    mask[3, :10] = 0.0
    y = torch.from_numpy(rng.integers(0, 5, 8))
    w = torch.ones(8)
    scfg = seq.SeqTrainConfig(lr=1e-3, dropout=0.1)
    runs = []
    for _ in range(2):
        m = copy.deepcopy(init).to(cuda)
        opt = torch.optim.Adam(m.parameters(), lr=scfg.lr)
        gen = torch.Generator(device=cuda).manual_seed(1)
        for _ in range(3):
            seq.train_step(m, opt, ids.to(cuda), mask.to(cuda), y.to(cuda),
                           w.to(cuda), scfg, generator=gen)
        runs.append([p.detach().cpu() for p in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        m = copy.deepcopy(init).to(dev)
        logits = tr.transformer_apply(m, ids.to(dev), mask.to(dev))
        seq.weighted_cross_entropy(logits, y.to(dev), w.to(dev)).backward()
        grads.append([logits.detach().cpu()]
                     + [p.grad.cpu() for p in m.parameters()])
    assert bool(torch.isfinite(grads[0][0]).all())
    for got, want in zip(*grads):
        assert_close_rel(got, want, tol=2.0 ** -7 * 1.125)
