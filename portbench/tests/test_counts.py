"""The operation and byte counts of the metric readers against a count
by hand on a tiny graph, and the readers on a made-up run."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

from portbench import peaks, spec
from portbench.record import RunRecord

# a 4-node graph: rows 0..3, train rows 1 and 3
#   row 0: cols 0, 1        row 1: cols 0, 1, 2
#   row 2: cols 1, 2        row 3: cols 3
CSR = sp.csr_matrix((np.ones(8, np.float32),
                     ([0, 0, 1, 1, 1, 2, 2, 3], [0, 1, 0, 1, 2, 1, 2, 3])),
                    shape=(4, 4))
IDX = np.array([1, 3])


def sgc_counts(F=3, C=2, steps=8):
    task = spec.task("sgc")
    return task.work_counts(CSR, IDX, F, C, degree=2, steps=steps)


def test_sgc_counts_by_hand():
    c = sgc_counts()
    assert c == {"n": 4, "nnz": 8, "used_cols": 4, "n_train": 2,
                 "nnz_final": 4, "used_cols_final": 4, "features": 3,
                 "classes": 2, "degree": 2, "newton_steps": 8}


def test_hop_least_time_by_hand():
    c = sgc_counts()
    # full hop: 2*8*3 = 48 ops; bytes 8*8 + 5*4 + (4 + 4)*3*4 = 180
    # last hop: 2*4*3 = 24 ops; bytes 4*8 + 3*4 + (4 + 2)*3*4 = 116
    want = (max(48 / peaks.FLOPS["fp32"], 180 / peaks.HBM_BYTES_PER_S)
            + max(24 / peaks.FLOPS["fp32"], 116 / peaks.HBM_BYTES_PER_S))
    mod = spec.metric_module("hop_roofline.sgc")
    assert mod.hop_least_s(c) == pytest.approx(want, rel=1e-12)


def test_fit_ops_by_hand():
    c = sgc_counts()
    mod = spec.metric_module("sgc_fit_mfu")
    # hops 2*3*(8 + 4) = 72; Gram 2*2*4*4 = 64; 8 steps of 3 products
    # of 2*2*4*2 = 32 -> 768
    assert mod.fit_ops(c) == 72 + 64 + 768


def gat_counts():
    return {"n": 4, "nnz": 8, "n_train": 2,
            "layers": [{"heads": 2, "f_in": 5, "f_out": 3},
                       {"heads": 2, "f_in": 6, "f_out": 4}]}


def test_sddmm_least_time_by_hand():
    mod = spec.metric_module("kernel_d_roofline.gat")
    # layer 1 (H F = 6): ops 2*8*6 = 96; bytes 2*4*6*4 + 8*8 + 8*2*4 = 320
    # layer 2 (H F = 8): ops 128; bytes 2*4*8*4 + 64 + 64 = 384
    want = (max(96 / peaks.FLOPS["fp32"], 320 / peaks.HBM_BYTES_PER_S)
            + max(128 / peaks.FLOPS["fp32"], 384 / peaks.HBM_BYTES_PER_S))
    assert mod.sddmm_least_s(gat_counts()) == pytest.approx(want, rel=1e-12)


def test_gat_step_ops_by_hand():
    mod = spec.metric_module("gat_step_mfu")
    # forward: layer 1 2*4*5*6 + 4*4*6 + 2*8*6 = 240 + 96 + 96 = 432;
    # layer 2 2*4*6*8 + 4*4*8 + 2*8*8 = 384 + 128 + 128 = 640
    # step: 3 * 1072 - 240 (no gradient of the input features)
    assert mod.step_ops(gat_counts()) == 3 * 1072 - 240


def made_up_run(config) -> RunRecord:
    rec = RunRecord(config=config, setup_s=12.5, window_s=3.0, steps=100,
                    step_ms=[float(i) for i in range(1, 101)])
    rec.spans = {"hops": [2.0, 4.0], "head": [6.0, 8.0],
                 "forward": [10.0], "backward": [20.0]}
    rec.setup_spans = {"plan_build_s": 4.25}
    rec.trace = {"steps": 10, "window_s": 0.5, "busy_s": 0.4,
                 "kernels": {"void sddmm_kernel<float, 2, 10, 2>(...)": 0.02,
                             "other": 0.38}, "idle": {"x": 0.1}}
    return rec


@pytest.mark.parametrize("name,want", [
    ("setup_s", 12.5), ("sgc_fit_ms", 30.0), ("gat_step_ms", 30.0),
    ("step_p95_ms.sgc", float(np.percentile(range(1, 101), 95))),
    ("step_p95_ms.gat", float(np.percentile(range(1, 101), 95))),
    ("plan_build_s", 4.25), ("hops_ms.sgc", 3.0), ("head_ms.sgc", 7.0),
    ("gat_forward_ms", 10.0), ("gat_backward_ms", 20.0),
    ("device_idle.sgc", 20.0), ("device_idle.gat", 20.0),
])
def test_readers_on_a_made_up_run(name, want):
    rec = made_up_run({"peak": "fp32"})
    assert spec.metric_reader(name)(rec) == pytest.approx(want)


def test_shares_on_a_made_up_run():
    rec = made_up_run({"peak": "fp32"})
    rec.counts = sgc_counts()
    hop = spec.metric_reader("hop_roofline.sgc")(rec)
    mod = spec.metric_module("hop_roofline.sgc")
    assert hop == pytest.approx(100 * mod.hop_least_s(rec.counts) / 3e-3)
    mfu = spec.metric_reader("sgc_fit_mfu")(rec)
    assert mfu == pytest.approx(100 * 904 / (0.05 * 67e12))
    rec.counts = gat_counts()
    d = spec.metric_reader("kernel_d_roofline.gat")(rec)
    dmod = spec.metric_module("kernel_d_roofline.gat")
    assert d == pytest.approx(100 * dmod.sddmm_least_s(gat_counts())
                              / 0.002)


@pytest.mark.parametrize("name", ["hops_ms.sgc", "head_ms.sgc",
                                  "hop_roofline.sgc", "sgc_fit_mfu",
                                  "device_idle.sgc", "kernel_d_roofline.gat",
                                  "gat_step_mfu", "gat_forward_ms",
                                  "plan_build_s"])
def test_readers_find_nothing_without_spans_or_trace(name):
    rec = RunRecord(config={"peak": "fp32"})
    assert spec.metric_reader(name)(rec) is None
