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
leave at most 2**-16 |x|).
"""

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
