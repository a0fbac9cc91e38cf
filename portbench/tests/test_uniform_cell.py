"""The uniform SGC cell on the CPU at a small scale: the frozen draw
against the program's, whole runs (sound, and with each fault the cell
can have planted in the timed path), and the control's and the faults'
readings over the limits.

The cell is not in ``BENCHMARK.json`` yet: on a program whose
``kernels.load_all`` checks the file system on every call, as
``sgc_precompute`` calls it, its fits' 95th percentile spreads over
more than its bound from run to run. These tests run it through
:data:`ENTRY` and :data:`JOINS`, the entry and the metric lists that
adding the cell puts in ``BENCHMARK.json``."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from portbench import graphgen, spec
from portbench.tests.conftest import SCALE, SEED
from portbench.tests.test_harness import _half_batch_head, _unchanged_head

CELL = "sgc-reddit.fit-uniform"
ENTRY = {"name": CELL, "config": "sgc-reddit", "traffic": "fit-uniform",
         "chips": 1,
         "why": "closed loop of whole SGC fits on the uniform 233K-node "
                "graph through sgc_precompute: kernel B gathers rows at "
                "random, the locality plan is bypassed"}
# the metrics whose readers find a value in the cell (not prop_ms.sgc:
# sgc_precompute has no prop.hop span)
JOINS = ("sgc_fit_ms", "step_p95_ms.sgc", "hops_ms.sgc", "head_ms.sgc",
         "hop_roofline.sgc", "sgc_fit_mfu", "device_idle.sgc",
         "head_factor_ms.sgc", "head_steps_ms.sgc", "head_search_ms.sgc",
         "host_syncs.sgc", "kernel_launches.sgc")
SHAPE = {"nodes": 232965, "edges": 11606919, "features": 602,
         "classes": 41, "train": 152410}


def with_cell(bench: spec.Benchmark) -> spec.Benchmark:
    """``bench`` with the cell added: :data:`ENTRY` last among the
    workloads, and the cell last in each of :data:`JOINS`' lists."""
    out = copy.copy(bench)
    out.data = copy.deepcopy(bench.data)
    out.data["workloads"].append(dict(ENTRY))
    for m in out.data["end_to_end"] + out.data["per_layer"]:
        if m["name"] in JOINS:
            m["workloads"].append(CELL)
    return out


@pytest.fixture(scope="module")
def bench():
    return with_cell(spec.Benchmark())


def test_entry_adds_one_cell_in_the_lists_of_existing_metrics():
    plain = spec.Benchmark()
    with pytest.raises(KeyError):
        plain.workload(CELL)
    names = {m["name"] for m in plain.data["end_to_end"]
             + plain.data["per_layer"]}
    assert set(JOINS) <= names
    added = with_cell(plain)
    assert added.workload(CELL)["config"] in {
        c["name"] for c in plain.data["configs"]}
    assert {m["name"] for m in added.end_to_end(CELL)} == {
        "sgc_fit_ms", "step_p95_ms.sgc", "setup_s"}
    assert plain.data == spec.Benchmark().data


@pytest.mark.parametrize("scale", [0.003, 0.01])
def test_uniform_draw_is_the_programs(scale):
    from sgc_tpu_torch.data.synthetic import synthetic_reddit
    from sgc_tpu_torch.graph.sparse import SparseGraph

    task = spec.task("sgc_uniform")
    data = task.uniform(SHAPE, 2 ** 31 + 5, scale)
    g, x, y, idx = synthetic_reddit(scale, seed=2 ** 31 + 5)
    mine = SparseGraph.from_scipy(graphgen.normalized(data))
    for k in ("rows", "cols", "vals", "row_ptr"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(g, k))
    np.testing.assert_array_equal(data.features, x)
    np.testing.assert_array_equal(data.labels, y)
    np.testing.assert_array_equal(data.idx_train, idx)
    assert data.n_classes == 41


def test_traffic_names_its_task(bench):
    cell = bench.workload(CELL)
    traffic = bench.traffic(cell["traffic"])
    task = spec.task_for(bench.config(cell["config"]), traffic)
    assert task.__file__.endswith("tasks/sgc_uniform.py")
    data = task.generate(SHAPE, dict(traffic["graph"], scale=0.01), 7)
    assert data.n == int(SHAPE["nodes"] * 0.01)
    with pytest.raises(ValueError, match="uniform"):
        task.generate(SHAPE, {"kind": "clustered"}, 7)


def test_sound_run_is_correct(run_small, bench):
    line = run_small(CELL, seconds=0.5)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"]
                                    for m in bench.end_to_end(CELL)}
    assert set(line["checks"]) == {"prop_err", "head_loss_gap"}


def _altered_row(monkeypatch):
    import sgc_tpu_torch.ops.propagate as propagate

    real = propagate.sgc_precompute

    def precompute(*args, **kwargs):
        out, seconds = real(*args, **kwargs)
        out = out.clone()
        out[0] = out[1]
        return out, seconds

    monkeypatch.setattr(propagate, "sgc_precompute", precompute)


@pytest.mark.parametrize("fault", [_unchanged_head, _half_batch_head,
                                   _altered_row],
                         ids=["unchanged", "half-batch", "altered-row"])
def test_broken_run_is_not_correct(run_small, monkeypatch, fault):
    fault(monkeypatch)
    line = run_small(CELL)
    assert line["correct"] is False, line["checks"]


def test_control_and_faults_read_over_the_limits(bench):
    torch.set_num_threads(2)
    cell = bench.workload(CELL)
    config = bench.config(cell["config"])
    traffic = copy.deepcopy(bench.traffic(cell["traffic"]))
    traffic["graph"]["scale"] = SCALE
    upper = spec.task_for(config, traffic).upper(config, traffic, SEED,
                                                 torch.device("cpu"))
    limits = {**config["limits"], **traffic["limits"]}

    def fails(nums):
        return any(v > limits[k] for k, v in nums.items())

    assert fails(upper["control"]), upper["control"]
    for fault, nums in upper["faults"].items():
        assert fails(nums), (fault, nums)
