"""Host plans of the sharded path, port against reference, bit for bit:
the three native partitioning entries (and their numpy twins),
``partition_graph``, ``build_halo`` (with and without ``overlap``), the
halo statistics and ``build_sharded_blockdense`` by both build routes,
at P = 4 and 8, on a random graph, a clustered one and one whose last
parts are short or empty.

Cells are compared as raw bf16 bits (the reference's ml_dtypes bfloat16
viewed as uint16).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from sgc_tpu import native as ref_native
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.parallel import blockdense as ref_bd
from sgc_tpu.parallel import halo as ref_halo
from sgc_tpu.parallel import partition as ref_part
from sgc_tpu_torch import native as port_native
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.parallel import blockdense as port_bd
from sgc_tpu_torch.parallel import halo as port_halo
from sgc_tpu_torch.parallel import partition as port_part


def _random(seed=1, n=300, density=0.04):
    return sp.random(n, n, density=density, random_state=seed,
                     format="coo", dtype=np.float32)


def _clustered(seed=0, n=256, communities=4):
    rng = np.random.default_rng(seed)
    per = n // communities
    blocks = [sp.random(per, per, density=0.5,
                        random_state=int(rng.integers(1 << 30)),
                        format="coo", dtype=np.float32)
              for _ in range(communities)]
    cross = sp.random(n, n, density=0.02, dtype=np.float32,
                      random_state=int(rng.integers(1 << 30)), format="coo")
    return (sp.block_diag(blocks, format="coo") + cross).tocoo()


def _short(seed=2):
    """29 rows: at P = 4 (8 rows a part) the last part has 5 rows; at
    P = 8 the last four parts are empty."""
    return _random(seed, n=29, density=0.2)


GRAPHS = {"random": _random, "clustered": _clustered, "short": _short}


def _pair(name):
    a = GRAPHS[name]()
    return RefGraph.from_scipy(a), PortGraph.from_scipy(a)


def _arrays_equal(ref_obj, port_obj, fields):
    for f in fields:
        r, p = getattr(ref_obj, f), getattr(port_obj, f)
        if isinstance(r, tuple):
            assert len(r) == len(p), f
            for i, (a, b) in enumerate(zip(r, p)):
                assert np.array_equal(np.asarray(a), np.asarray(b)), \
                    f"{f}[{i}]"
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
            continue
        r = np.asarray(r)
        if r.dtype.name == "bfloat16":
            r = r.view(np.uint16)
        p = np.asarray(p)
        assert r.dtype == p.dtype, f"{f}: {r.dtype} vs {p.dtype}"
        assert np.array_equal(r, p), f


@pytest.mark.parametrize("seed", [0, 1])
def test_native_entries_match_reference_and_twins(seed):
    rng = np.random.default_rng(seed)
    n, e = 1000, 20000
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    vals = rng.standard_normal(e).astype(np.float32)
    # duplicates keep their order under both sorts
    rows[:50], cols[:50] = rows[50:100], cols[50:100]

    bufs = {}
    for name, fn in (("ref", ref_native.sort_edges_inplace),
                     ("port", port_native.sort_edges_inplace),
                     ("twin", port_native.sort_edges_inplace_plain)):
        r, c, v = (rows.astype(np.int64), cols.astype(np.int64),
                   vals.copy())
        fn(r, c, v, n, n)
        bufs[name] = (r, c, v)
    for name in ("port", "twin"):
        for a, b in zip(bufs["ref"], bufs[name]):
            assert np.array_equal(a, b), name
    r, c, v = bufs["ref"]

    for P, rpp in ((4, 256), (8, 128), (7, 150)):
        counts = ref_native.edge_counts(r, P, rpp)
        assert np.array_equal(port_native.edge_counts(r, P, rpp), counts)
        assert np.array_equal(port_native.edge_counts_plain(r, P, rpp),
                              counts)
        e_max = int(counts.max()) + 17
        want = ref_native.partition_edges(r, c, v, P, rpp, e_max, n)
        for fn in (port_native.partition_edges,
                   port_native.partition_edges_plain):
            got = fn(r, c, v, P, rpp, e_max, n)
            for a, b in zip(want, got):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_native_entries_validate():
    r = np.arange(10, dtype=np.int64)
    c, v = r.copy(), np.ones(10, np.float32)
    with pytest.raises(ValueError, match="int32|int64"):
        port_native.sort_edges_inplace(r.astype(np.int32), c, v, 10, 10)
    with pytest.raises(ValueError, match="e_max"):
        port_native.partition_edges(r, c, v, 2, 5, 3, 10)
    with pytest.raises(ValueError, match=">= 0"):
        port_native.edge_counts(-r, 2, 5)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("P", [4, 8])
def test_partition_and_halo_match_reference(graph, P):
    rg, pg_ = _pair(graph)
    ref = ref_part.partition_graph(rg, P, device=False)
    port = port_part.partition_graph(pg_, P, device=False)
    _arrays_equal(ref, port, ("rows_local", "cols", "vals"))
    for f in ("n_parts", "rows_per_part", "n_rows", "n_cols", "nnz",
              "n_rows_padded", "edges_per_part"):
        assert getattr(ref, f) == getattr(port, f), f

    for overlap in (False, True):
        rh = ref_halo.build_halo(ref, overlap=overlap, device=False)
        ph = port_halo.build_halo(port, overlap=overlap, device=False)
        assert (rh.halo_width, rh.n_parts, rh.overlapped) == (
            ph.halo_width, ph.n_parts, ph.overlapped)
        _arrays_equal(rh, ph, ("send_idx", "cols_halo") + (
            ("edges_int", "edges_bnd") if overlap else ()))
        assert ref_halo.halo_fraction(rh, ref) == port_halo.halo_fraction(
            ph, port)

    assert ref_halo.halo_stats(ref) == port_halo.halo_stats(port)
    assert np.array_equal(ref_halo.pair_width_matrix(ref),
                          port_halo.pair_width_matrix(port))
    for hosts in (1, 2, P):
        assert np.array_equal(ref_halo.host_union_widths(ref, hosts),
                              port_halo.host_union_widths(port, hosts))
    with pytest.raises(ValueError, match="not divisible"):
        port_halo.host_union_widths(port, 3)


BD_FIELDS = ("cells_int", "rb_int", "st_int", "vis_int", "cells_bnd",
             "rb_bnd", "st_bnd", "vis_bnd", "rest_int", "rest_bnd",
             "send_idx")
BD_META = ("row_block", "stripe", "n_parts", "rows_per_part", "halo_width",
           "r_up", "t_pad", "chunk_int", "chunk_bnd", "n_cells",
           "dense_edges", "sparse_edges", "n_rb", "dense_fraction")


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("admission", [
    dict(min_edges=2.0), dict(min_edges=None),
    dict(min_edges=0.0, byte_budget=2 * 32 * 32 * 3)])
def test_sharded_blockdense_matches_reference(graph, P, admission,
                                              monkeypatch):
    rg, pg_ = _pair(graph)
    ref_p = ref_part.partition_graph(rg, P, device=False)
    port_p = port_part.partition_graph(pg_, P, device=False)
    rh = ref_halo.build_halo(ref_p, device=False)
    ph = port_halo.build_halo(port_p, device=False)
    kw = dict(n_features=16, row_block=32, stripe=32, **admission)

    ref = ref_bd.build_sharded_blockdense(ref_p, rh, device=False, **kw)
    monkeypatch.setenv("SGC_TPU_PORTABLE_SHARDED_BUILD", "1")
    ref_portable = ref_bd.build_sharded_blockdense(ref_p, rh, device=False,
                                                   **kw)
    fast = port_bd.build_sharded_blockdense(port_p, ph, device=False, **kw)
    portable = port_bd._build_sharded_portable(
        port_p, ph, kw["n_features"], kw["row_block"], kw["stripe"],
        kw["min_edges"], kw.get("byte_budget", port_bd.DEFAULT_BYTE_BUDGET),
        False)
    for want, got in ((ref, fast), (ref_portable, portable), (ref, portable)):
        _arrays_equal(want, got, BD_FIELDS)
        for f in BD_META:
            assert getattr(want, f) == getattr(got, f), f
    assert np.array_equal(fast.part_cells_int, portable.part_cells_int)
    assert np.array_equal(fast.part_cells_bnd, portable.part_cells_bnd)
    # each part's real cells come first; a pad slot repeats the last one
    for p in range(P):
        k = int(fast.part_cells_int[p])
        assert not np.any(fast.cells_int[p, k:])
        if k:
            assert np.all(fast.rb_int[p, k:] == fast.rb_int[p, k - 1])


def test_pad_helpers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((29, 13)).astype(np.float32)
    for n_pad in (29, 32, 40):
        want = np.asarray(ref_part.pad_node_rows(x, n_pad))
        assert np.array_equal(port_part.pad_node_rows(x, n_pad), want)
        import torch

        assert np.array_equal(
            port_part.pad_node_rows(torch.from_numpy(x), n_pad).numpy(),
            want)
    for m in (1, 8, 16):
        want = np.asarray(ref_part.pad_feature_dim(x, m))
        assert np.array_equal(port_part.pad_feature_dim(x, m), want)
    with pytest.raises(ValueError, match="rows"):
        port_part.pad_node_rows(x, 20)


def test_partition_placed_on_a_device():
    _, g = _pair("short")
    host_plan = port_part.partition_graph(g, 4, device=False)
    placed = port_part.partition_graph(g, 4, device="cpu")
    assert placed.rows_local.device.type == "cpu"
    assert np.array_equal(placed.vals.numpy(), host_plan.vals)
    halo = port_halo.build_halo(placed, overlap=True, device="cpu")
    want = port_halo.build_halo(host_plan, overlap=True, device=False)
    assert np.array_equal(halo.send_idx.numpy(), want.send_idx)
    assert all(np.array_equal(a.numpy(), b)
               for a, b in zip(halo.edges_bnd, want.edges_bnd))
    assert dataclasses.is_dataclass(halo)
