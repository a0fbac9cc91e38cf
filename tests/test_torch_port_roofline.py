"""``sgc_tpu_torch/ops/roofline.py`` against the reference's roofline and
against the counts ``chip_smoke.py`` computed inline before they moved
into the module.

* The fields the reference shares (``flops_useful``, ``flops_padded``,
  the remainder's ``edges``, the report's keys, its zero-cell and
  no-remainder guards) equal the reference's on the same small split.
* The port's byte and operation counts and bounds equal the smoke's
  formulas, copied below as the oracle (``ORACLE_*``), on a small split,
  a tiled layout and a graph: kernel A's bound with its one-pass and
  dense-form bounds, kernel B's remainder count and ``b_bound``, kernel
  C's count and kernel D's bound.
* ``default_peaks()`` is the H100 data sheet's, and the reference's
  environment variables override it.
"""

import numpy as np
import pytest
import torch

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops import roofline as ref_rf
from sgc_tpu.ops.spmm_blockdense import split_block_dense as ref_split

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import roofline as rf
from sgc_tpu_torch.ops import spmm_tiled as ti
from sgc_tpu_torch.ops.spmm_blockdense import (
    blockdense_device_args,
    split_block_dense,
)

# ---- the oracle: chip_smoke.py's inline counts, as they were written
ORACLE_PEAK_FP32_FLOPS = 67e12
ORACLE_PEAK_BF16_TC_FLOPS = 989e12
ORACLE_PEAK_HBM_BYTES = 3.35e12


def oracle_bound_ms(ops, nbytes, peak_flops=ORACLE_PEAK_FP32_FLOPS):
    t_ops = ops / peak_flops
    t_bytes = nbytes / ORACLE_PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def oracle_kernel_a_bound(split, dargs, n_cells, F, passes):
    R, W = split.row_block, split.stripe
    nnz = int(dargs.cells[: split.n_slots].count_nonzero())
    ops = 2.0 * nnz * F
    dense_ops = 2.0 * R * W * F * n_cells
    nbytes = (split.n_slots * R * W * 2 + split.n_cols * F * 4
              + split.n_rows * F * 4
              + (split.n_row_blocks + 1 + 2 * split.n_slots) * 4)
    b_ms, b_by = oracle_bound_ms(ops * passes, nbytes,
                                 ORACLE_PEAK_BF16_TC_FLOPS)
    one_ms, _ = oracle_bound_ms(ops, nbytes, ORACLE_PEAK_BF16_TC_FLOPS)
    dense_ms, dense_by = oracle_bound_ms(dense_ops * passes, nbytes,
                                         ORACLE_PEAK_BF16_TC_FLOPS)
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_one_pass_ms": one_ms,
            "cell_nonzeros": nnz, "ops": ops * passes, "bytes": nbytes,
            "dense_form_ops": dense_ops * passes,
            "dense_form_bound_ms": dense_ms,
            "dense_form_bound_by": dense_by}


def oracle_remainder(split, rest, F):
    """phase_kernel_b's count of the main split's remainder."""
    n_used_cols = int(np.unique(split.rest.cols[:rest.nnz]).size)
    ops = 2.0 * rest.nnz * F + rest.n_rows * F
    nbytes = (rest.nnz * 8 + (rest.n_rows + 1) * 4 + n_used_cols * F * 4
              + 2 * rest.n_rows * F * 4)
    return ops, nbytes


def oracle_b_bound(graph, F, dense=False):
    nnz = graph.nnz
    used = int(torch.unique(graph.cols[:nnz]).numel())
    ops = 2.0 * nnz * F
    nbytes = (nnz * 8 + (graph.n_rows + 1) * 4
              + (used + graph.n_rows * (2 if dense else 1)) * F * 4)
    return oracle_bound_ms(ops, nbytes)


def oracle_kernel_c(split_dense_edges, tiled, edges, F):
    ops = 2.0 * split_dense_edges * F
    nbytes = (edges * 8 + (tiled.n_rows + 1) * 4 + tiled.n_cols * F * 4
              + tiled.n_rows * F * 4)
    return ops, nbytes


def oracle_sddmm_bound(g, a, itemsize):
    F = int(a.shape[1])
    ops = 2.0 * g.nnz * F
    nbytes = ((g.n_rows + g.n_cols) * F * itemsize + g.nnz * 8
              + g.n_edges_padded * 4)
    return (*oracle_bound_ms(ops, nbytes), ops, nbytes)


# ---- inputs

def graph_coo(seed=0, n=512, e=6000, corner=128):
    """One dense corner plus a uniform tail, as the reference's test."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, corner, e), rng.integers(0, n, e // 4)])
    c = np.concatenate([rng.integers(0, corner, e), rng.integers(0, n, e // 4)])
    return r, c, rng.random(len(r)).astype(np.float32), n


def splits(min_edges):
    r, c, v, n = graph_coo()
    kw = dict(row_block=128, stripe=128, min_edges=min_edges)
    return (split_block_dense(SparseGraph.from_coo(r, c, v, n, n), 64, **kw),
            ref_split(RefGraph.from_coo(r, c, v, n, n, device=False), 64,
                      **kw))


def keys(d):
    return {k: keys(v) if isinstance(v, dict) and k != "peaks" else None
            for k, v in d.items()}


@pytest.mark.parametrize("min_edges,case", [
    (200.0, "cells and remainder"), (1e9, "no cell"), (0.0, "no remainder")])
def test_shared_fields_equal_reference(min_edges, case):
    port, ref = splits(min_edges)
    assert (port.n_cells, port.dense_edges) == (ref.n_cells, ref.dense_edges)
    if case == "no cell":
        assert port.n_cells == 0
    if case == "no remainder":
        assert port.rest is None and ref.rest is None
    d, w = rf.dense_term_cost(port, 64), ref_rf.dense_term_cost(ref, 64)
    assert set(d) == set(w)
    for k in ("flops_padded", "flops_useful"):
        assert d[k] == w[k], k
    assert d["bytes"] == rf.kernel_a_bytes(port, 64)
    got = rf.roofline_report(port, 64, dense_s=0.01, rest_s=0.005,
                             dispatch_s=0.001)
    want = ref_rf.roofline_report(ref, 64, dense_s=0.01, rest_s=0.005,
                                  dispatch_s=0.001)
    assert keys(got) == keys(want)
    assert got["remainder"]["edges"] == want["remainder"]["edges"]
    assert got["dense"]["seconds"] == want["dense"]["seconds"]
    if case == "no cell":
        for k in ("bytes", "achieved_gbps", "hbm_frac", "mxu_frac_padded",
                  "mxu_frac_useful"):
            assert got["dense"][k] == want["dense"][k] == 0.0, k
        assert got["remainder"]["edges_per_s"] > 0
    if case == "no remainder":
        for k in ("bytes", "achieved_gbps", "hbm_frac", "edges_per_s"):
            assert got["remainder"][k] == want["remainder"][k] == 0, k
        assert got["dense"]["bytes"] > 0


@pytest.mark.parametrize("min_edges,dense", [
    (200.0, True), (1e9, False), (0.0, None)])
def test_remainder_cost_is_kernel_b_count(min_edges, dense):
    """The remainder's bytes: kernel B's count with the dense term only
    where the split has cells (``dense``), none without a remainder
    (``None``); the report reads the same numbers."""
    split, _ = splits(min_edges)
    got = rf.remainder_cost(split, 64)
    if dense is None:
        assert split.rest is None
        assert got == {"bytes": 0.0, "edges": 0}
    else:
        assert (split.n_cells > 0) == dense
        assert got == {
            "bytes": float(rf.kernel_b_count(split.rest, 64, dense)[1]),
            "edges": split.rest.nnz}
    rep = rf.roofline_report(split, 64, dense_s=0.01, rest_s=0.005)
    assert (rep["remainder"]["bytes"], rep["remainder"]["edges"]) == (
        got["bytes"], got["edges"])


def test_scan_form_raises():
    port, _ = splits(200.0)
    with pytest.raises(ValueError, match="apply_cells_scan"):
        rf.dense_term_cost(port, 64, form="scan")
    with pytest.raises(ValueError, match="apply_cells_scan"):
        rf.roofline_report(port, 64, 0.01, 0.005, form="scan")


@pytest.mark.parametrize("F,passes", [(64, 2), (602, 2), (602, 1)])
def test_kernel_a_and_b_counts_equal_the_smoke_formulas(F, passes):
    split, _ = splits(200.0)
    dargs = blockdense_device_args(split, "cpu")
    assert rf.kernel_a_bound(split, dargs, split.n_cells, F, passes) == \
        oracle_kernel_a_bound(split, dargs, split.n_cells, F, passes)
    rest = dargs.rest
    assert rf.kernel_b_count(split.rest, F, dense=True) == \
        oracle_remainder(split, rest, F)
    assert rf.kernel_b_count(rest, F, dense=True) == \
        oracle_remainder(split, rest, F)
    for dense in (False, True):
        assert rf.b_bound(rest, F, dense) == oracle_b_bound(rest, F, dense)
    # the report's remainder bytes are kernel B's remainder count
    rep = rf.roofline_report(split, F, dense_s=0.002, rest_s=0.001)
    assert rep["remainder"]["bytes"] == oracle_remainder(split, rest, F)[1]
    assert rep["dense"]["bytes"] == oracle_kernel_a_bound(
        split, dargs, split.n_cells, F, passes)["bytes"]


def test_kernel_c_and_d_counts_equal_the_smoke_formulas():
    r, c, v, n = graph_coo(seed=3, n=700)
    g = SparseGraph.from_coo(r, c, v, n, n)
    tiled = ti.tile_graph(g, 256, 256, 128)
    edges = int(ti.tiled_device_args(tiled, "cpu").cols.shape[0])
    for F in (1, 41, 602):
        assert rf.kernel_c_count(tiled, g.nnz, edges, F) == \
            oracle_kernel_c(g.nnz, tiled, edges, F)
        a = torch.zeros((n, F))
        for itemsize in (2, 4):
            assert rf.sddmm_bound(g, F, itemsize) == \
                oracle_sddmm_bound(g, a, itemsize)
    gt = g.to("cpu")
    for F in (1, 8, 602):
        assert rf.b_bound(gt, F) == oracle_b_bound(gt, F)
        assert rf.b_bound(g, F) == oracle_b_bound(gt, F)   # host arrays


def test_default_peaks_and_overrides(monkeypatch):
    monkeypatch.delenv("SGC_TPU_PEAK_GBPS", raising=False)
    monkeypatch.delenv("SGC_TPU_PEAK_TFLOPS", raising=False)
    assert rf.default_peaks() == {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                                  "fp32_tflops": 67.0}
    assert (rf.PEAK_HBM_BYTES, rf.PEAK_BF16_TC_FLOPS, rf.PEAK_FP32_FLOPS) == (
        ORACLE_PEAK_HBM_BYTES, ORACLE_PEAK_BF16_TC_FLOPS,
        ORACLE_PEAK_FP32_FLOPS)
    monkeypatch.setenv("SGC_TPU_PEAK_GBPS", "2000")
    monkeypatch.setenv("SGC_TPU_PEAK_TFLOPS", "500")
    peaks = rf.default_peaks()
    assert (peaks["hbm_gbps"], peaks["bf16_tflops"]) == (2000.0, 500.0)
    split, _ = splits(200.0)
    rep = rf.roofline_report(split, 64, dense_s=0.01, rest_s=0.005)
    assert rep["peaks"] == peaks
