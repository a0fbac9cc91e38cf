"""Fixtures of the benchmark's tests: the parsed ``BENCHMARK.json``, a
cell run on the CPU at a small scale, and the card for the tests marked
``cuda``."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from portbench import spec

# the CPU runs' graph: 2% of Reddit's sizes (4,659 nodes, 232,138 edge
# draws, 3,048 train rows), where the float32 head is conditioned as at
# full scale within the limits
SCALE = 0.02
SEED = 2 ** 31 + 11


@pytest.fixture(scope="session")
def bench():
    return spec.Benchmark()


@pytest.fixture
def card():
    """The CUDA device; skips without one (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def all_sparse(monkeypatch):
    """The plan admits no dense cell, as the calibrated plan on the card
    does at full scale (on the CPU it would admit cells by the committed
    TPU rates, whose bf16 cell values the float32 limits do not cover)."""
    import sgc_tpu_torch.ops.spmm_blockdense as bd

    monkeypatch.setattr(bd, "min_edges_for", lambda *a, **k: 2 ** 62)


@pytest.fixture
def run_small(bench, all_sparse):
    """``run_small(cell_name, seconds=0.0)``: the cell's result line from
    a run on the CPU at :data:`SCALE`, the chip's look skipped."""
    from portbench.run import run_cell

    torch.set_num_threads(2)

    def go(name: str, seconds: float = 0.0, seed: int = SEED) -> dict:
        cell = bench.workload(name)
        traffic = copy.deepcopy(bench.traffic(cell["traffic"]))
        traffic["graph"]["scale"] = SCALE
        return run_cell(bench, cell, bench.config(cell["config"]), traffic,
                        seed, seconds, False, torch.device("cpu"),
                        time.perf_counter())

    return go
