"""Kernels E and F on the CPU: the launch plans and bounds their CUDA
kernels are held to on the card (tests/test_torch_port_cuda.py).

- F's launch plan (``ops/row_gather.py::gather_plan``): which path a
  launch takes (the load path, the bulk-copy ring, the ``cp.async``
  ring), its grid (at most one wave of the CTAs an SM holds), its rows a
  round and its shared memory, against hand counts; and, through
  ``plan_rows`` (the kernel's own walk of the rows), that every plan
  copies each output row exactly once.
- E's and F's bound (``ops/roofline.py::copy_count``, ``copy_bound``):
  bytes and operations, and the launch floor set beside them, against
  hand counts.
- E's and F's wrappers on CPU tensors run their plain versions, and the
  raw-stream getter that the kernels launch on raises where PyTorch has
  no CUDA.
"""

import numpy as np
import pytest
import torch

from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops import probe_copy as pe
from sgc_tpu_torch.ops import roofline as rf
from sgc_tpu_torch.ops import row_gather as rg
from sgc_tpu_torch.utils.profiling import read_counts

N_OUT = (1, 63, 64, 65536, 65537)
# (F, entry, in_flight, aligned) of every path
PLANS = [(768, "load", 8, True), (256, "load", 8, True),
         (41, "load", 8, True), (768, "load", 8, False),
         (768, "async", 1, True), (768, "async", 8, True),
         (768, "async", 16, True), (256, "async", 8, True),
         (41, "async", 16, True), (768, "async", 8, False)]


@pytest.mark.parametrize("n_out", N_OUT)
@pytest.mark.parametrize("F,entry,in_flight,aligned", PLANS)
def test_plan_copies_every_row_exactly_once(n_out, F, entry, in_flight,
                                            aligned):
    plan = rg.gather_plan(n_out, F, entry, in_flight, aligned)
    rows = np.concatenate(rg.plan_rows(plan, n_out))
    assert len(rows) == n_out
    assert np.array_equal(np.sort(rows), np.arange(n_out))


@pytest.mark.parametrize("F,entry,in_flight,aligned", PLANS)
def test_plan_fits_one_wave_and_shared_memory(F, entry, in_flight, aligned):
    for n_out in N_OUT:
        plan = rg.gather_plan(n_out, F, entry, in_flight, aligned)
        assert 1 <= plan.grid <= n_out
        assert plan.smem_bytes <= 232448
        if plan.path == "load":
            per_sm = rg.LOAD_MIN_CTAS
        else:
            per_sm = min(32, 2048 // plan.threads,
                         233472 // (plan.smem_bytes + 1024))
        assert plan.grid <= 132 * per_sm


# hand counts at the take probe's 65,536 rows: (F, entry, in_flight,
# aligned) -> (path, vec, grid, threads, rows a round, slot, smem)
HAND = {
    # 192 float4 a row: 256 // 192 = 1 row a round; 65,536 rounds over 8
    # warps a CTA want 8,192 CTAs, capped at 132 x 4
    (768, "load", 8, True): ("load", 4, 528, 256, 1, 0, 0),
    # 64 float4 a row: 4 rows a round
    (256, "load", 8, True): ("load", 4, 528, 256, 4, 0, 0),
    # 41 floats a row: 256 // 41 = 6 rows a round
    (41, "load", 8, True): ("load", 1, 528, 256, 6, 0, 0),
    # 4 bytes off: 768 floats a row, 1 row a round
    (768, "load", 8, False): ("load", 1, 528, 256, 1, 0, 0),
    # 16 slots of 3,072 bytes + 16 mbarriers = 49,280 bytes; 233,472 //
    # 50,304 = 4 CTAs an SM
    (768, "async", 16, True): ("bulk", 4, 528, 32, 16, 3072, 49280),
    # 8 slots: 24,640 bytes, 233,472 // 25,664 = 9 CTAs an SM
    (768, "async", 8, True): ("bulk", 4, 1188, 32, 8, 3072, 24640),
    # one slot: 3,080 bytes; 32 CTAs an SM at most
    (768, "async", 1, True): ("bulk", 4, 4224, 32, 1, 3072, 3080),
    # F = 41: cp.async, 64 threads (41 pieces rounded up to a warp), 16
    # slots of 164 bytes
    (41, "async", 16, True): ("cp_async", 1, 4224, 64, 16, 164, 2624),
    # 4 bytes off: cp.async, 256 threads (8 CTAs an SM by threads)
    (768, "async", 8, False): ("cp_async", 1, 1056, 256, 8, 3072, 24576),
}


@pytest.mark.parametrize("key", sorted(HAND, key=str))
def test_plan_against_hand_counts(key):
    plan = rg.gather_plan(65536, *key)
    got = (plan.path, plan.vec, plan.grid, plan.threads,
           plan.rows_per_round, plan.slot_bytes, plan.smem_bytes)
    assert got == HAND[key]


def test_plan_small_outputs_shrink_the_grid():
    # 63 rows of 768: 63 rounds of one row, 8 warps a CTA -> 8 CTAs; the
    # ring: one CTA a row
    assert rg.gather_plan(63, 768, "load").grid == 8
    assert rg.gather_plan(63, 768, "async", 8).grid == 63
    # the DMA probe: 64 rows of 256, 4 a round -> 16 rounds, 2 CTAs
    dma = rg.gather_plan(64, 256, "load")
    assert (dma.grid, dma.rows_per_round) == (2, 4)


def test_plan_refuses_a_ring_over_shared_memory():
    # 16 slots of 4,096 floats: 262,272 bytes
    with pytest.raises(ValueError, match="shared memory"):
        rg.gather_plan(100, 4096, "async", 16)
    assert rg.gather_plan(100, 4096, "async", 8).smem_bytes == 8 * 16392
    with pytest.raises(ValueError):
        rg.gather_plan(0, 768, "load")
    with pytest.raises(ValueError):
        rg.gather_plan(10, 768, "async", 3)


def test_plan_variant_overrides():
    # 4 vectors a lane, 8 CTAs an SM: 128 // 64 = 2 rows of 256 a round
    p = rg.gather_plan(65536, 256, "load", load_k=4, load_ctas=8)
    assert (p.grid, p.rows_per_round) == (1056, 2)
    # 16 vectors a lane: two rows of 768 a round
    assert rg.gather_plan(65536, 768, "load",
                          load_k=16, load_ctas=2).rows_per_round == 2


def test_copy_count_against_hand_counts():
    # E's scale2 at (8, 128): 1,024 floats read, 1,024 written, a doubling
    # each
    assert rf.copy_count(1024, 1024, 0, 1) == (1024.0, 8192)
    # F at the take probe: u distinct rows of 768 read, 65,536 written,
    # 65,536 int32 indices
    u = 2048
    assert rf.copy_count(u * 768, 65536 * 768, 65536) == (
        0.0, 4 * (u * 768 + 65536 * 768 + 65536))


def test_copy_bound_sets_the_launch_floor_beside_the_bytes():
    b = rf.copy_bound(1024, 1024, 0, 1, launch_floor_ms=0.008)
    assert b["bytes"] == 8192 and b["ops"] == 1024.0
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(8192 / 3.35e12 * 1e3)
    assert b["floor_ms"] == 0.008 and b["floor_by"] == "launch"
    # the take probe: 201 MB written, far above a launch
    n = 65536 * 768
    t = rf.copy_bound(2048 * 768, n, 65536, launch_floor_ms=0.008)
    assert t["bound_ms"] == pytest.approx(
        4 * (2048 * 768 + n + 65536) / 3.35e12 * 1e3)
    assert t["floor_ms"] == t["bound_ms"] and t["floor_by"] == "bytes"
    # not measured: no floor
    assert "floor_ms" not in rf.copy_bound(8, 8)
    assert rf.copy_bound(8, 8)["launch_floor_ms"] is None


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(37, 41, generator=g)
    idx = torch.randint(0, 37, (100,), generator=g, dtype=torch.int32)
    before = read_counts()
    assert torch.equal(pe.scale2(x), x * 2.0)
    assert torch.equal(rg.row_gather(x, idx, "async", 16), x[idx.long()])
    assert read_counts() == before


def test_stream_of_reads_the_raw_stream_or_raises():
    if kernels._RAW_STREAM is None:
        with pytest.raises(RuntimeError, match="no CUDA build"):
            kernels.stream_of(torch.zeros(1))
    else:
        assert kernels._RAW_STREAM is torch._C._cuda_getCurrentRawStream
