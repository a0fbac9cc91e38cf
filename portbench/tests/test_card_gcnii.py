"""Runs of the GCNII cell and the uniform SGC cell on the card, at full
size and a short window (``python -m pytest portbench/tests -q -m cuda``
on a machine with a CUDA device; skipped without one): each correct,
each reporting its end-to-end metrics, and in a traced run every
per-layer metric that lists it, the new ones among them (and the step's
forward and backward phases, ``gat_forward_ms`` and ``gat_backward_ms``,
which the GCNII task records as the GAT task does). The uniform cell,
not in ``BENCHMARK.json`` yet, runs through the entry that its CPU tests
hold (test_uniform_cell.py)."""

from __future__ import annotations

import json

import pytest

from portbench import run
from portbench.tests import test_uniform_cell as uniform

CELLS = ["gcnii-reddit.train", "sgc-reddit.fit-uniform"]
NEW = {"gcnii-reddit.train": {"gcnii_prop_ms", "kernel_b_roofline.gcnii",
                              "gcnii_step_mfu", "kernel_launches.gcnii",
                              "device_idle.gcnii", "gat_forward_ms",
                              "gat_backward_ms"},
       "sgc-reddit.fit-uniform": set()}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_new_cell_runs_correct_on_the_card(card, bench, capsys, name,
                                           trace):
    from sgc_tpu_torch.utils import profiling

    # the recorder's windowed counts are the process's: a traced run of
    # another cell earlier in this process would add to this one's
    profiling.reset_trace()
    if name == uniform.CELL:
        bench = uniform.with_cell(bench)
        cell = bench.workload(name)
        line = run.run_cell(bench, cell, bench.config(cell["config"]),
                            bench.traffic(cell["traffic"]), 2 ** 31 + 107,
                            2.0, bool(trace), card)
    else:
        rc = run.main(["--workload", name, "--seed", str(2 ** 31 + 107),
                       "--seconds", "2", "--trace", str(trace)])
        assert rc == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    chosen = bench.per_layer(name) if trace else bench.end_to_end(name)
    assert set(line["metrics"]) == {m["name"] for m in chosen}
    assert NEW[name] <= set(line["metrics"]) or not trace
    for m in chosen:
        if m["unit"] == "%":
            assert 0 < line["metrics"][m["name"]]["value"] <= 100
    if trace and name == "gcnii-reddit.train":
        assert line["metrics"]["kernel_launches.gcnii"]["value"] == 128
