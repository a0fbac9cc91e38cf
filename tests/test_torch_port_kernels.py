"""The port's kernel modules against the reference, and the CUDA kernels
against their plain versions.

On the CPU the kernel wrappers run their plain PyTorch versions; these
are held against the reference's own functions (the Pallas dense term in
interpret mode and its scan form, at both precisions, and
``spmm_segment``) with rtol = atol = 1e-5 relative to max|ref|: at
``precision="bf16"`` both sides round x to bf16 the same way, so at
either precision only the f32 summation order differs. The CUDA kernels
themselves are tested in test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops.spmm import spmm_segment as ref_spmm_segment
from sgc_tpu.ops import spmm_blockdense as ref_bd

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
    """Edges concentrated in a few diagonal (block x block) cells plus a
    uniform sparse tail; leaves some row blocks without dense cells."""
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


def both_graphs(rows, cols, vals, n):
    return (RefGraph.from_coo(rows, cols, vals, n, n, device=False),
            PortGraph.from_coo(rows, cols, vals, n, n))


@pytest.mark.parametrize("super_rows,group_cells", [
    (None, None), (4, None), (4, 2)])
@pytest.mark.parametrize("min_edges", [300.0, 1e9])
def test_plain_dense_term_matches_reference_pallas(super_rows, group_cells,
                                                   min_edges):
    """Partial admission (some dense cells stay sparse), unvisited row
    blocks, ragged n and F, both cell orders and the grouped layout; with
    min_edges=1e9 the op is the remainder alone."""
    n, f = 1000, 37
    rows, cols, vals = community_coo(0, n, 128, 4, 700, 3000)
    rg, pg = both_graphs(rows, cols, vals, n)
    x = np.random.default_rng(1).standard_normal((n, f)).astype(np.float32)
    kw = dict(row_block=128, stripe=128, min_edges=min_edges,
              super_rows=super_rows, group_cells=group_cells)
    rsplit = ref_bd.split_block_dense(rg, f, **kw)
    psplit = port_bd.split_block_dense(pg, f, **kw)
    if min_edges < 1e9:
        visited = set(psplit.rb_ids.tolist())
        assert 0 < len(visited) < psplit.n_row_blocks
        assert psplit.rest is not None
    want = ref_bd.spmm_blockdense_pallas(rsplit, jnp.asarray(x),
                                         interpret=True, precision="f32")
    xt = torch.from_numpy(x)
    plain = port_bd.spmm_block_dense(psplit, xt, precision="f32")
    assert_close_rel(plain.numpy(), want)
    # on a CPU tensor the kernel-form op is its plain version, exactly
    kernel_form = port_bd.spmm_blockdense(psplit, xt, precision="f32")
    assert torch.equal(kernel_form, plain)


def test_plain_dense_term_alone_matches_reference_scan():
    """apply_cells_plain (no remainder) vs the reference's scan form of
    the dense term, cells only."""
    n, f = 700, 20
    rows, cols, vals = community_coo(2, n, 128, 3, 900, 0)
    rg, pg = both_graphs(rows, cols, vals, n)
    x = np.random.default_rng(3).standard_normal((n, f)).astype(np.float32)
    rsplit = ref_bd.split_block_dense(rg, f, 128, 128, min_edges=100)
    psplit = port_bd.split_block_dense(pg, f, 128, 128, min_edges=100)
    assert psplit.rest is None and psplit.n_cells == 3
    want = ref_bd.spmm_block_dense(rsplit, jnp.asarray(x), precision="f32")
    args = port_bd.blockdense_device_args(psplit, "cpu")
    got = port_bd.apply_cells(psplit, args, torch.from_numpy(x),
                              precision="f32")
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("super_rows,group_cells", [
    (None, None), (4, None), (4, 2)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_blockdense_precision_matches_reference(precision, super_rows,
                                                group_cells):
    """spmm_block_dense (plain) and spmm_blockdense (its kernel form) at
    each precision against the reference's Pallas dense term in
    interpret mode and its scan form, on the layouts of the test above
    (partial admission, ragged n and F, a remainder)."""
    n, f = 1000, 37
    rows, cols, vals = community_coo(0, n, 128, 4, 700, 3000)
    rg, pg = both_graphs(rows, cols, vals, n)
    x = np.random.default_rng(1).standard_normal((n, f)).astype(np.float32)
    kw = dict(row_block=128, stripe=128, min_edges=300.0,
              super_rows=super_rows, group_cells=group_cells)
    rsplit = ref_bd.split_block_dense(rg, f, **kw)
    psplit = port_bd.split_block_dense(pg, f, **kw)
    xt = torch.from_numpy(x)
    got = port_bd.spmm_block_dense(psplit, xt, precision=precision)
    want = ref_bd.spmm_blockdense_pallas(rsplit, jnp.asarray(x),
                                         interpret=True, precision=precision)
    assert_close_rel(got.numpy(), want)
    assert torch.equal(
        port_bd.spmm_blockdense(psplit, xt, precision=precision), got)
    if group_cells is None:   # the scan form takes the ungrouped layouts
        want = ref_bd.spmm_block_dense(rsplit, jnp.asarray(x),
                                       precision=precision)
        assert_close_rel(got.numpy(), want)
    # the two precisions are different functions: bf16(x) moves the rows
    # by far more than the tolerance
    other = port_bd.spmm_block_dense(
        psplit, xt, precision="bf16" if precision == "f32" else "f32")
    diff = float((other - got).abs().max()) / float(got.abs().max())
    assert diff > 100 * TOL


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_dense_term_alone_matches_reference_scan_at_precision(precision):
    """apply_cells (no remainder) at each precision vs the reference's
    scan form of the dense term, cells only."""
    n, f = 700, 20
    rows, cols, vals = community_coo(2, n, 128, 3, 900, 0)
    rg, pg = both_graphs(rows, cols, vals, n)
    x = np.random.default_rng(3).standard_normal((n, f)).astype(np.float32)
    rsplit = ref_bd.split_block_dense(rg, f, 128, 128, min_edges=100)
    psplit = port_bd.split_block_dense(pg, f, 128, 128, min_edges=100)
    want = ref_bd.spmm_block_dense(rsplit, jnp.asarray(x),
                                   precision=precision)
    args = port_bd.blockdense_device_args(psplit, "cpu")
    got = port_bd.apply_cells(psplit, args, torch.from_numpy(x),
                              precision=precision)
    assert_close_rel(got.numpy(), want)
    plain = port_bd.apply_cells_plain(psplit, args, torch.from_numpy(x),
                                      precision=precision)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("n_terms,bound", [(1, 2.0**-8), (2, 2.0**-16),
                                           (3, 0.0)])
def test_bf16_terms_reconstruct_x(n_terms, bound):
    """The bf16 terms of x sum back to x within 2**(-8 n) |x| (three
    terms exactly), over magnitudes from 1e-30 to 1e30."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((300, 21))
         * 10.0 ** rng.uniform(-30, 30, (300, 21))).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1.0, -3.0]
    xt = torch.from_numpy(x)
    terms = port_bd.bf16_terms(xt, n_terms)
    assert len(terms) == n_terms
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    resid = (total - xt.double()).abs()
    assert bool((resid <= bound * xt.double().abs()).all())
    if n_terms == 3:
        assert torch.equal(total.float(), xt)


def test_precision_is_checked():
    n, f = 300, 8
    rows, cols, vals = community_coo(5, n, 128, 1, 600, 200)
    pg = PortGraph.from_coo(rows, cols, vals, n, n)
    split = port_bd.split_block_dense(pg, f, 128, 128, min_edges=100)
    for fn in (port_bd.spmm_blockdense, port_bd.spmm_block_dense):
        with pytest.raises(ValueError, match="precision"):
            fn(split, torch.zeros(n, f), precision="tf32")


@pytest.mark.parametrize("with_dense", [False, True])
def test_plain_remainder_matches_reference_segment(with_dense):
    n, f = 500, 29
    rng = np.random.default_rng(4)
    rows = rng.integers(0, n, 6000)
    cols = rng.integers(0, n, 6000)
    vals = rng.standard_normal(6000).astype(np.float32)
    rg, pg = both_graphs(rows, cols, vals, n)
    x = rng.standard_normal((n, f)).astype(np.float32)
    dense = rng.standard_normal((n, f)).astype(np.float32)
    want = np.asarray(ref_spmm_segment(rg, jnp.asarray(x)))
    got = port_spmm.spmm_segment(
        pg.to("cpu"), torch.from_numpy(x),
        torch.from_numpy(dense) if with_dense else None)
    if with_dense:
        want = dense + want
    assert_close_rel(got.numpy(), want)


def test_spmm_segment_validates_inputs():
    g = PortGraph.from_coo(np.array([0, 1]), np.array([1, 0]),
                           np.ones(2, np.float32), 2, 2)
    with pytest.raises(ValueError, match="x must be"):
        port_spmm.spmm_segment(g.to("cpu"), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="graph on"):
        port_spmm.spmm_segment(g, torch.zeros(2, 4))


def test_blockdense_missing_args_guards():
    n, f = 300, 8
    rows, cols, vals = community_coo(5, n, 128, 1, 600, 200)
    pg = PortGraph.from_coo(rows, cols, vals, n, n)
    split = port_bd.split_block_dense(pg, f, 128, 128, min_edges=100)
    args = port_bd.blockdense_device_args(split, "cpu")
    x = torch.zeros(n, f)
    import dataclasses

    with pytest.raises(ValueError, match="cells"):
        port_bd.spmm_blockdense(split, x, dataclasses.replace(args,
                                                             cells=None))
    with pytest.raises(ValueError, match="remainder"):
        port_bd.spmm_blockdense(split, x, dataclasses.replace(args,
                                                             rest=None))
