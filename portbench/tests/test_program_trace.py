"""The readers of the program's own spans and counters
(``program_trace.py``) on a made-up recorder summary and profiled
window: per traced step, and None without a window, without the
recorder, or without the span or counter."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.record import RunRecord

# a window of 4 traced steps: the program's summary over all of them
SUMMARY = {
    "spans": {
        "prop.hop": {"count": 8, "device_ms": 28.0, "host_ms": 1.0},
        "head.factor": {"count": 4, "device_ms": 16.0, "host_ms": 2.0},
        "head.step": {"count": 32, "device_ms": 64.0, "host_ms": 3.0},
        "head.search": {"count": 32, "device_ms": 24.0, "host_ms": 1.5},
        "gat.spmm": {"count": 384, "device_ms": 160.0, "host_ms": 9.0},
        "gat.scores": {"count": 384, "device_ms": 40.0, "host_ms": 4.0},
        "gat.softmax": {"count": 384, "device_ms": 60.0, "host_ms": 5.0},
        "on.the.cpu": {"count": 4, "device_ms": None, "host_ms": 1.0},
    },
    "counts": {"host_sync": 80, "launch.csr_spmm": 392,
               "launch.sddmm": 64, "within.csr_spmm_transposed": 128},
}

# metric -> its value per step on SUMMARY over 4 steps
WANT = {"prop_ms.sgc": 7.0, "head_factor_ms.sgc": 4.0,
        "head_steps_ms.sgc": 16.0, "head_search_ms.sgc": 6.0,
        "host_syncs.sgc": 20.0, "kernel_launches.sgc": 114.0,
        "kernel_launches.gat": 114.0, "gat_spmm_ms": 40.0,
        "gat_scores_ms": 10.0, "gat_softmax_ms": 15.0}


def traced_run(steps=4) -> RunRecord:
    return RunRecord(config={}, trace={"steps": steps, "window_s": 1.0,
                                       "busy_s": 0.9, "kernels": {},
                                       "idle": {}})


@pytest.fixture
def recorded(monkeypatch):
    """The program's recorder reads ``summary`` (a dict to fill)."""
    from sgc_tpu_torch.utils import profiling

    summary = {"spans": {}, "counts": {}}
    monkeypatch.setattr(profiling, "trace_summary", lambda: summary)
    return summary


def test_every_new_metric_is_in_the_benchmark(bench):
    names = {m["name"] for m in bench.data["per_layer"]}
    assert set(WANT) <= names


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_per_traced_step(recorded, name):
    recorded.update(SUMMARY)
    assert spec.metric_reader(name)(traced_run()) == pytest.approx(
        WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_a_window_is_none(recorded, name):
    recorded.update(SUMMARY)
    assert spec.metric_reader(name)(RunRecord(config={})) is None
    assert spec.metric_reader(name)(traced_run(steps=0)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_span_or_counter_is_none(recorded, name):
    assert spec.metric_reader(name)(traced_run()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_program_without_the_recorder_is_none(monkeypatch,
                                                         name):
    from sgc_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "trace_summary")
    assert spec.metric_reader(name)(traced_run()) is None


def test_span_off_the_card_reads_none(recorded):
    from portbench.program_trace import span_ms

    recorded.update(SUMMARY)
    assert span_ms(traced_run(), "on.the.cpu") is None


def test_launch_sum_leaves_out_the_sub_counts(recorded):
    from portbench.program_trace import count

    recorded.update(SUMMARY)
    # 392 + 64 launches; the 128 over the transpose are among the 392
    assert count(traced_run(), "launch.") == (392 + 64) / 4
    assert count(traced_run(), "within.") == 128 / 4
