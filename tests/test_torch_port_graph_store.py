"""The port's graph store and host helpers against the reference's, on the
same seeded inputs, all exact:

* ``save_graph`` / ``load_graph``: a round trip, and files written by
  either package loading in the other (the ``.npz`` suffix rule
  included);
* ``block_diag``: the batched graph and its offsets, and its
  ``ValueError`` for a non-square member;
* ``native.sym_normalize_edges`` (the library and its numpy twin): the
  same bits as the reference's, inputs untouched, and its ``ValueError``;
* ``RedditConfig``: the same fields and defaults.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgc_tpu import native as ref_native
from sgc_tpu.graph import sparse as ref_sparse
from sgc_tpu.utils import config as ref_config

from sgc_tpu_torch import native as port_native
from sgc_tpu_torch.graph import sparse as port_sparse
from sgc_tpu_torch.ops.spmm import spmm_segment
from sgc_tpu_torch.utils import config as port_config


def coo(seed, n_rows, n_cols, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_rows, e), rng.integers(0, n_cols, e),
            rng.standard_normal(e).astype(np.float32))


def pair(seed, n=300, e=2500, n_cols=None):
    rows, cols, vals = coo(seed, n, n_cols or n, e)
    return (port_sparse.SparseGraph.from_coo(rows, cols, vals, n, n_cols or n),
            ref_sparse.SparseGraph.from_coo(rows, cols, vals, n, n_cols or n,
                                            device=False))


def assert_graph_equal(got, want):
    assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols,
                                                 want.nnz)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(port_sparse.host(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def test_save_load_round_trip(tmp_path):
    g, _ = pair(0)
    port_sparse.save_graph(tmp_path / "sub" / "g.npz", g)
    back = port_sparse.load_graph(tmp_path / "sub" / "g.npz")
    for f in ("rows", "cols", "vals", "row_ptr"):
        np.testing.assert_array_equal(getattr(back, f), getattr(g, f))
    assert (back.shape, back.nnz) == (g.shape, g.nnz)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (g.n_cols, 4)).astype(np.float32))
    assert torch.equal(spmm_segment(back.to("cpu"), x),
                       spmm_segment(g.to("cpu"), x))
    # a graph on a device saves the same file content
    port_sparse.save_graph(tmp_path / "t.npz", g.to("cpu"))
    with np.load(tmp_path / "t.npz") as a, \
            np.load(tmp_path / "sub" / "g.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_packages(tmp_path, writer):
    """Written without the suffix (numpy appends it), loaded by the
    other package by the bare name."""
    g, rg = pair(2, n=200, e=1500, n_cols=260)
    path = tmp_path / "graph"
    if writer == "port":
        port_sparse.save_graph(path, g)
        back = ref_sparse.load_graph(path, pad_multiple=1024)
        assert_graph_equal(g, back)
    else:
        ref_sparse.save_graph(path, rg)
        back = port_sparse.load_graph(path)
        assert_graph_equal(back, rg)
    assert (tmp_path / "graph.npz").exists()
    with np.load(tmp_path / "graph.npz") as z:
        assert sorted(z.files) == ["cols", "rows", "shape", "vals"]
        assert z["shape"].dtype == np.int64


def test_block_diag_equals_reference():
    members = [pair(s, n=n, e=e) for s, n, e in
               ((3, 50, 300), (4, 1, 0), (5, 130, 900), (6, 64, 2000))]
    got, got_off = port_sparse.block_diag([p for p, _ in members])
    want, want_off = ref_sparse.block_diag([r for _, r in members])
    assert_graph_equal(got, want)
    np.testing.assert_array_equal(got.row_ptr, np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got_off, want_off)
    assert got_off.dtype == want_off.dtype
    # each block's product is its member's
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (got.n_rows, 3)).astype(np.float32))
    out = spmm_segment(got.to("cpu"), x)
    for k, (p, _) in enumerate(members):
        lo, hi = got_off[k], got_off[k + 1]
        assert torch.equal(out[lo:hi], spmm_segment(p.to("cpu"), x[lo:hi]))
    empty, off = port_sparse.block_diag([])
    assert (empty.n_rows, empty.nnz, list(off)) == (0, 0, [0])


def test_block_diag_rejects_non_square_as_reference():
    p, r = pair(8, n=40, e=100, n_cols=50)
    with pytest.raises(ValueError) as want:
        ref_sparse.block_diag([r])
    with pytest.raises(ValueError) as got:
        port_sparse.block_diag([p])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("impl", ["native", "plain"])
def test_sym_normalize_edges_equals_reference(impl):
    n = 400
    rows, cols, vals = coo(9, n, n, 5000)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], np.abs(vals[order])
    vals[:50] = 0.0                       # zero-degree rows appear too
    keep = rows.copy(), cols.copy(), vals.copy()
    want = ref_native.sym_normalize_edges(rows, cols, vals, n)
    if impl == "native":
        assert port_native.available()
        fn = port_native.sym_normalize_edges
    else:
        fn = port_native.sym_normalize_edges_plain
    got = fn(rows, cols, vals, n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip((rows, cols, vals), keep):
        np.testing.assert_array_equal(a, b)


def test_sym_normalize_edges_rejects_out_of_range_cols_as_reference():
    rows, cols, vals = np.array([0, 1]), np.array([0, 5]), np.ones(2)
    with pytest.raises(ValueError) as want:
        ref_native.sym_normalize_edges(rows, cols, vals, 3)
    for fn in (port_native.sym_normalize_edges,
               port_native.sym_normalize_edges_plain):
        with pytest.raises(ValueError) as got:
            fn(rows, cols, vals, 3)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="row ids"):
            fn(np.array([0, 4]), np.array([0, 1]), vals, 3)


def test_reddit_config_equals_reference():
    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert spec(port_config.RedditConfig) == spec(ref_config.RedditConfig)
    assert port_config.RedditConfig() == port_config.RedditConfig(
        **dataclasses.asdict(ref_config.RedditConfig()))
