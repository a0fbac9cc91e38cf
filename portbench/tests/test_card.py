"""Runs of each cell on the card, at full size and a short window
(``python -m pytest portbench/tests -q -m cuda`` on a machine with a
CUDA device; skipped without one)."""

from __future__ import annotations

import json

import pytest

from portbench import run

CELLS = ["sgc-reddit.fit-clustered", "gat-reddit.train"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, bench, capsys, name, trace):
    rc = run.main(["--workload", name, "--seed", str(2 ** 31 + 101),
                   "--seconds", "2", "--trace", str(trace)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    chosen = bench.per_layer(name) if trace else bench.end_to_end(name)
    assert set(line["metrics"]) == {m["name"] for m in chosen}
    for m in chosen:
        if m["unit"] == "%":
            assert 0 < line["metrics"][m["name"]]["value"] <= 100
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
