"""Kernels G and H on the CPU: the definitions their CUDA kernels are
held to on the card (tests/test_torch_port_cuda.py), and their roofline
terms against hand counts.

- G's bucket pass (``ops/edge_accumulate.py::bucket_edges``): its plain
  version is a stable argsort of the effective rows and the prefix sum of
  their counts, held here bit for bit against numpy's stable argsort on
  seeded edges, in every mode (fixed_out and noop put every edge on row
  0); the accumulate pass on those buckets gives the whole function's
  bits.
- G's chain bound (``ops/roofline.py::chain_bound_ms``): a row of E edges
  in edge order is E dependent f32 adds.
- H's reads (``ops/roofline.py::kernel_h_traffic``): each cell byte once a
  feature tile, each cell's x stripe once a row tile.
"""

import numpy as np
import pytest
import torch

from sgc_tpu_torch.ops import blockdense_int8 as h
from sgc_tpu_torch.ops import edge_accumulate as ea
from sgc_tpu_torch.ops import roofline as rf


def edges(seed, E, R, W, F, hub=None):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, R, E).astype(np.int32)
    if hub is not None:
        rows[rng.rand(E) < 0.9] = hub
    cols = rng.randint(0, W, E).astype(np.int32)
    vals = rng.rand(E).astype(np.float32)
    x = rng.rand(W, F).astype(np.float32)
    return rows, cols, vals, x


CASES = {"uniform": (0, 5000, 300, 77, 9, None),
         "hub": (1, 3000, 64, 40, 5, 7),
         "one_row": (2, 700, 1, 30, 3, None)}


@pytest.mark.parametrize("mode", ea.MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bucket_definition_is_a_stable_argsort(mode, case):
    rows, cols, vals, x = edges(*CASES[case])
    R = CASES[case][2]
    b = ea.bucket_edges_plain(*(torch.from_numpy(a)
                                for a in (rows, cols, vals)), R, mode)
    fixed_row = mode in ("fixed_out", "noop")
    fixed_col = mode in ("fixed_in", "noop")
    r_eff = np.zeros_like(rows) if fixed_row else rows
    c_eff = np.zeros_like(cols) if fixed_col else cols
    order = np.argsort(r_eff, kind="stable")
    assert np.array_equal(b.perm.numpy(), order.astype(np.int32))
    want_ptr = np.concatenate([[0], np.cumsum(np.bincount(r_eff,
                                                          minlength=R))])
    assert np.array_equal(b.row_ptr.numpy(), want_ptr.astype(np.int32))
    assert np.array_equal(b.cols.numpy(), c_eff[order])
    assert np.array_equal(b.vals.numpy(), vals[order])
    counts = np.diff(want_ptr)
    heavy = [] if mode == "store" else np.flatnonzero(counts > ea.HEAVY)
    n = int(b.n_heavy)
    assert n == len(heavy)
    assert np.array_equal(b.heavy.numpy()[:n], np.asarray(heavy))


@pytest.mark.parametrize("mode", ea.MODES)
def test_accumulate_on_buckets_is_the_whole_function(mode):
    rows, cols, vals, x = (torch.from_numpy(a)
                           for a in edges(*CASES["hub"]))
    R = CASES["hub"][2]
    b = ea.bucket_edges(rows, cols, vals, x, R, mode)
    got = ea.accumulate_buckets(b, x, R, mode)
    assert torch.equal(got, ea.edge_accumulate(rows, cols, vals, x, R, mode))


@pytest.mark.parametrize("E,R", [(5001, 37), (70000, 2048), (900, 20000)])
def test_scratch_parts_fit_their_sizes(E, R):
    """The kernel's scratch: one allocation cut into the bucket pass's
    parts, the chunk table [ceil(E / chunk), R] first."""
    buf, ptrs = ea._scratch(E, R, "cpu")
    b = ea._buckets_of(buf, E, R)
    chunks = -(-E // ea.BUCKET_CHUNK)
    assert b.offs.shape == (chunks, R) and b.row_ptr.shape == (R + 1,)
    assert b.perm.shape == b.cols.shape == b.vals.shape == (E,)
    assert b.vals.dtype == torch.float32
    assert buf.numel() == chunks * R + 4 * E + 2 * R + 2
    assert ptrs[1] == buf.data_ptr() == b.offs.data_ptr()
    assert ptrs[2] == b.row_ptr.data_ptr() and ptrs[6] == b.cols.data_ptr()
    assert ptrs[0] == b.local_rank.data_ptr()
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("n,cycles,ghz,want_ms", [
    (65536, 4.0, 1.98, 65536 * 4 / 1.98e9 * 1e3),
    (70000, 4.05, 1.755, 70000 * 4.05 / 1.755e9 * 1e3),
    (1, 4.0, 2.0, 2e-6)])
def test_chain_bound_is_links_times_latency(n, cycles, ghz, want_ms):
    assert rf.chain_bound_ms(n, cycles, ghz) == pytest.approx(want_ms,
                                                              rel=1e-12)


def test_chain_bound_defaults_at_the_probe():
    """The probe's 65,536 edges on one row at 4 cycles and 1.98 GHz:
    about 0.13 ms."""
    assert rf.chain_bound_ms(65536) == pytest.approx(0.13239596, rel=1e-6)


def _cells(k, R=512, W=512, n_rb=3, n_st=2):
    q = torch.zeros((k, R, W), dtype=torch.int8)
    return h.int8_cells(q, torch.ones(k), [i % n_rb for i in range(k)],
                        [i % n_st for i in range(k)], n_rb=n_rb, n_st=n_st)


@pytest.mark.parametrize("f_pad,tile_features,reads", [
    (768, 256, 3), (768, 128, 6), (384, 256, 2), (256, 256, 1)])
def test_kernel_h_reads_each_cell_once_a_feature_tile(f_pad, tile_features,
                                                      reads):
    k = 5
    c = _cells(k)
    t = rf.kernel_h_traffic(c, f_pad, tile_features=tile_features)
    assert t["cell_reads"] == t["feature_tiles"] == reads
    assert t["row_tiles"] == 512 // 128
    assert t["cell_bytes_read"] == reads * k * 512 * 512
    assert t["x_bytes_read"] == k * 4 * 512 * f_pad * 2
    assert t["l2_bytes_read"] == t["cell_bytes_read"] + t["x_bytes_read"]


def test_kernel_h_traffic_at_the_main_split_shape():
    """At the main split's shape (R = W = 512, 768 wide) each slot's cell
    is read 3 times and its 768-wide stripe 4 times (once a row tile)."""
    c = _cells(4)
    t = rf.kernel_h_traffic(c, 768)
    per_slot_cells = 512 * 512
    per_slot_x = 4 * 512 * 768 * 2
    assert t["cell_bytes_read"] == 3 * 4 * per_slot_cells
    assert t["x_bytes_read"] == 4 * per_slot_x
