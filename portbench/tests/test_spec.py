"""``BENCHMARK.json`` holds to the benchmark's contract, and everything
it names loads from its own files by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench.data) == TOP_KEYS
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench.data["run_seconds"] <= 51
    assert isinstance(bench.data["run_seconds"], int)


def test_command_and_paths(bench):
    cmd, paths = bench.data["command"], bench.data["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()


def test_every_name_and_unit(bench):
    d = bench.data
    names = [c["name"] for c in d["configs"]]
    names += [w["name"] for w in d["workloads"]]
    names += [w["config"] for w in d["workloads"]]
    names += [w["traffic"] for w in d["workloads"]]
    names += [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    names += [k for c in d["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for group in ("configs", "workloads"):
        listed = [e["name"] for e in d[group]]
        assert len(listed) == len(set(listed))
    metrics = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys(bench, group, keys):
    entries = bench.data[group]
    assert entries
    for e in entries:
        extra = set(e) - keys
        assert set(e) >= keys and extra <= {"workloads"}, e["name"]
        if group in ("configs", "workloads"):
            assert "workloads" not in e
        for k in ("why", "layer", "source"):
            if k in e and group != "end_to_end" and group != "per_layer":
                assert _line(e[k])
        if "layer" in e:
            assert _line(e["layer"])


def test_cells_and_metrics_cover_each_other(bench):
    d = bench.data
    cells = {w["name"] for w in d["workloads"]}
    used = {w["config"] for w in d["workloads"]}
    assert used == {c["name"] for c in d["configs"]}
    assert len({(w["config"], w["traffic"]) for w in d["workloads"]}) \
        == len(cells)
    four = [w for w in d["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in d["workloads"])
    assert len(four) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = {m["name"] for m in bench.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        layers = bench.per_layer(cell)
        assert layers, cell
        for m in layers:
            assert m["moves"] in reported, (cell, m["name"])
    for m in d["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_are_named_alike(bench):
    """Metrics of one layer name it letter for letter."""
    by_head = {}
    for m in bench.data["per_layer"]:
        head = m["layer"].split(":")[0]
        by_head.setdefault(head, set()).add(m["layer"])
    for head, spelled in by_head.items():
        assert len(spelled) == 1, spelled


def test_configs_load_with_their_keys(bench):
    for entry in bench.data["configs"]:
        path = spec.ROOT / entry["file"]
        assert path.is_relative_to(spec.PACKAGE)
        cfg = bench.config(entry["name"])
        assert cfg["name"] == entry["name"]
        assert cfg["reduced"] == entry["reduced"]
        for key in ("model", "source", "shape", "precision", "peak",
                    "assumed", "limits", "departures"):
            assert key in cfg, (entry["name"], key)
        spec.task(cfg["model"])
    files = [c["file"] for c in bench.data["configs"]]
    assert len(files) == len(set(files))


def test_every_cell_finds_its_files(bench):
    for cell in bench.data["workloads"]:
        traffic = bench.traffic(cell["traffic"])
        assert traffic["loop"] == "closed"
        cfg = bench.config(cell["config"])
        assert spec.task_for(cfg, traffic).run
    for m in bench.data["end_to_end"] + bench.data["per_layer"]:
        assert callable(spec.metric_reader(m["name"])), m["name"]


def test_traffic_files_are_data(bench):
    for cell in bench.data["workloads"]:
        path = spec.PACKAGE / "traffic" / f"{cell['traffic']}.json"
        json.loads(Path(path).read_text())


def test_traffic_may_name_its_task():
    """A traffic mix that drives another entry names its task; without
    one, the configuration's model drives it."""
    cfg = {"model": "sgc"}
    assert spec.task_for(cfg, {}).__file__.endswith("tasks/sgc.py")
    assert spec.task_for(cfg, {"task": "gat"}).__file__.endswith(
        "tasks/gat.py")


def test_a_metric_of_a_cell_group_shares_its_reader():
    """``<base>.<group>`` is read by ``metrics/<base>.py`` where it has no
    file of its own, and by its own file where it has one."""
    shared = spec.metric_module("device_idle.gcn")
    assert shared.__file__.endswith("metrics/device_idle.py")
    own = spec.metric_module("hops_ms.sgc")
    assert own.__file__.endswith("metrics/hops_ms.sgc.py")
    with pytest.raises(FileNotFoundError):
        spec.metric_module("no_such_metric")
