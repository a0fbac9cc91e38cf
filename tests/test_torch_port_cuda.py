"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode). The file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: rtol = atol = 1e-5 relative to max|plain|, since kernel and
plain version differ only in the order of the f32 sums.
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


def _main_path_like_split(super_rows):
    n, f = 1300, 602      # ragged row blocks and feature tiles
    rows, cols, vals = community_coo(6, n, 512, 2, 30000, 20000)
    pg = PortGraph.from_coo(rows, cols, vals, n, n)
    split = port_bd.split_block_dense(pg, f, min_edges=5000.0,
                                      super_rows=super_rows)
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
def test_cuda_blockdense_op_and_capability(cuda):
    from sgc_tpu_torch.ops.capability import require_cuda_kernels

    assert require_cuda_kernels(cuda).type == "cuda"
    split, x = _main_path_like_split(8)
    xd = x.to(cuda)
    got = port_bd.spmm_blockdense(split, xd)
    want = port_bd.spmm_block_dense(split, xd)
    assert_close_rel(got.cpu().numpy(), want.cpu().numpy())
