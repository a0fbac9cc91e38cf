"""The GCNII cell on the CPU at a small scale: its operation and byte
counts against a count by hand, whole runs (sound, and with each fault
the cell can have planted in the timed path), the control's and the
faults' readings over the limits, and the float64 reference against the
port's CPU path."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import graphgen, peaks, spec
from portbench.record import RunRecord
from portbench.tests.conftest import SCALE, SEED
from portbench.tests.test_harness import _half_batch_loss, _unchanged_state

CELL = "gcnii-reddit.train"

# the 4-node graph of test_counts.py: rows 0..3; row 3 has an edge, every
# row does, and column 3 is used
CSR = sp.csr_matrix((np.ones(8, np.float32),
                     ([0, 0, 1, 1, 1, 2, 2, 3], [0, 1, 0, 1, 2, 1, 2, 3])),
                    shape=(4, 4))


def counts(layers=2, hidden=3):
    data = graphgen.GraphData(None, None, np.zeros((4, 5), np.float32),
                              None, np.array([1, 3]), 4, 2)
    return spec.task("gcnii").work_counts(
        CSR, data, {"layers": layers, "hidden": hidden})


def test_counts_by_hand():
    assert counts() == {"n": 4, "nnz": 8, "used_cols": 4, "used_cols_t": 4,
                        "n_train": 2, "features": 5, "classes": 2,
                        "layers": 2, "hidden": 3}


@pytest.mark.parametrize("dense", [0, 1, 2])
def test_kernel_b_least_time_by_hand(dense):
    mod = spec.metric_module("kernel_b_roofline.gcnii")
    # a product: 2*8*3 = 48 ops; bytes 8*8 + 5*4 + (4 + 4)*3*4 = 180, and
    # 4*3*4 = 48 more with the dense operand
    one = max(48 / peaks.FLOPS["fp32"], 180 / peaks.HBM_BYTES_PER_S)
    with_dense = max(48 / peaks.FLOPS["fp32"], 228 / peaks.HBM_BYTES_PER_S)
    want = dense * with_dense + (2 - dense) * one + 2 * one
    assert mod.products_least_s(counts(), dense) == pytest.approx(
        want, rel=1e-12)


def test_step_ops_by_hand():
    mod = spec.metric_module("gcnii_step_mfu")
    # forward: input 2*4*5*3 = 120; 2 layers of 2*8*3 + 2*4*3*3 = 48 + 72;
    # output 2*4*3*2 = 48 -> 408; step 3 * 408 - 120
    assert mod.step_ops(counts()) == 3 * 408 - 120


def test_readers_on_a_made_up_run(monkeypatch):
    from portbench import program_trace

    rec = RunRecord(config={"peak": "fp32"}, steps=10, window_s=1.0)
    rec.counts = counts()
    rec.trace = {"steps": 4, "window_s": 0.4, "busy_s": 0.3,
                 "kernels": {"void (anonymous namespace)::csr_spmm_kernel"
                             "<4, false, 1, false>(...)": 0.008,
                             "other": 0.2}, "idle": {}}
    summary = {"spans": {"gcnii.prop": {"count": 16, "device_ms": 20.0,
                                        "host_ms": 1.0}},
               "counts": {"launch.csr_spmm": 16,
                          "within.csr_spmm_dense": 8,
                          "within.csr_spmm_transposed": 8}}
    rec.spans = {"forward": [30.0, 32.0], "backward": [60.0, 62.0],
                 "optimizer": [1.0, 1.0]}
    monkeypatch.setattr(program_trace, "summary", lambda: summary)
    read = spec.metric_reader
    assert read("gcnii_prop_ms")(rec) == pytest.approx(5.0)
    assert read("gat_forward_ms")(rec) == pytest.approx(31.0)
    assert read("gat_backward_ms")(rec) == pytest.approx(61.0)
    assert read("kernel_launches.gcnii")(rec) == pytest.approx(4.0)
    assert read("device_idle.gcnii")(rec) == pytest.approx(25.0)
    mod = spec.metric_module("kernel_b_roofline.gcnii")
    assert read("kernel_b_roofline.gcnii")(rec) == pytest.approx(
        100 * mod.products_least_s(rec.counts, 2.0) / 0.002)
    assert read("gcnii_step_mfu")(rec) == pytest.approx(
        100 * (3 * 408 - 120) / (0.1 * 67e12))
    empty = RunRecord(config={"peak": "fp32"})
    for name in ("gcnii_prop_ms", "kernel_b_roofline.gcnii",
                 "gcnii_step_mfu", "kernel_launches.gcnii",
                 "device_idle.gcnii", "gat_forward_ms", "gat_backward_ms"):
        assert read(name)(empty) is None, name


def test_kernel_b_share_without_the_counter(monkeypatch):
    """A program without ``within.csr_spmm_dense`` reads as no dense
    launch, never as a failure."""
    from portbench import program_trace

    rec = RunRecord(config={"peak": "fp32"})
    rec.counts = counts()
    rec.trace = {"steps": 1, "window_s": 1.0, "busy_s": 1.0,
                 "kernels": {"csr_spmm_kernel<1>": 0.001}, "idle": {}}
    monkeypatch.setattr(program_trace, "summary", lambda: None)
    mod = spec.metric_module("kernel_b_roofline.gcnii")
    assert spec.metric_reader("kernel_b_roofline.gcnii")(rec) == \
        pytest.approx(100 * mod.products_least_s(rec.counts, 0) / 0.001)


def test_sound_run_is_correct(run_small, bench):
    line = run_small(CELL, seconds=0.5)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"]
                                    for m in bench.end_to_end(CELL)}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "logit_gap"}


def _altered_logits(monkeypatch):
    import sgc_tpu_torch.models.gcnii as gcnii

    real = gcnii.gcnii_apply

    def apply(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[:10] = out[10:20]   # at SEED, train rows among them
        return out

    monkeypatch.setattr(gcnii, "gcnii_apply", apply)


def _dropped_residual(monkeypatch):
    """The middle layer's ``alpha h0`` left out of its product."""
    import sgc_tpu_torch.models.gcnii as gcnii

    real, calls = gcnii.spmm, [0]

    def spmm(graph, x, *args, dense=None, **kwargs):
        calls[0] += 1
        if calls[0] % 64 == 32:
            dense = None
        return real(graph, x, *args, dense=dense, **kwargs)

    monkeypatch.setattr(gcnii, "spmm", spmm)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch_loss,
                                   _altered_logits, _dropped_residual],
                         ids=["unchanged", "half-batch", "altered-logits",
                              "dropped-residual"])
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
    upper = spec.task("gcnii").upper(config, traffic, SEED,
                                     torch.device("cpu"))
    limits = config["limits"]

    def fails(nums):
        return any(v > limits[k] for k, v in nums.items())

    assert fails(upper["control"]), upper["control"]
    assert set(upper["faults"]) == {"half_batch", "unchanged",
                                    "altered_logits", "dropped_residual"}
    for fault, nums in upper["faults"].items():
        assert fails(nums), (fault, nums)


def test_reference_against_the_port_at_a_tiny_size():
    """The float64 reference's first logits and loss against the port's
    CPU path on an 8-layer model at 1% scale."""
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models.gcnii import GCNII, gcnii_apply, scaled_operator

    from portbench.reference import gcnii as ref

    torch.set_num_threads(2)
    bench = spec.Benchmark()
    config = dict(bench.config("gcnii-reddit"), layers=8)
    data = graphgen.generate(config["shape"], {"kind": "clustered",
                                               "scale": 0.01}, SEED)
    task = spec.task("gcnii")
    init = task.init_leaves(SEED, config, data.features.shape[1],
                            data.n_classes, torch.device("cpu"))
    g = SparseGraph.from_scipy(graphgen.normalized(data)).to("cpu")
    model = GCNII(*(init[k].clone() for k in task.LEAVES))
    got = gcnii_apply(model, torch.as_tensor(data.features),
                      scaled_operator(g, 0.1), 0.1, 0.5).detach()
    want = ref.train(init, data.src, data.dst, data.n, data.features,
                     data.labels, data.idx_train, {"alpha": 0.1,
                                                   "lambda": 0.5},
                     config["optimizer"], 1, "cpu")
    idx = torch.as_tensor(data.idx_train)
    gap = float((got[idx].double() - want["logits1"]).abs().max()
                / want["logits1"].abs().max())
    assert gap < 1e-6
