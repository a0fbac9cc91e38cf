"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``portbench/configs/<config>.json``;
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a metric (end-to-end or per-layer): ``portbench/metrics/<name>.py``,
  loaded by path (a name may hold dots), whose ``read(run)`` returns the
  value or None when it finds nothing to read; a name ``<base>.<cell
  group>`` with no file of its own is read by ``metrics/<base>.py``;
* the system under test of a cell: ``portbench/tasks/<task>.py``, where
  ``<task>`` is the traffic file's ``task`` key or, without one, the
  configuration's ``model``; loaded by path too.

Nothing here knows a cell, a configuration or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """The parsed ``BENCHMARK.json`` of ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = read_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return read_json(self.root / entry["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return read_json(PACKAGE / "traffic" / f"{name}.json")

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics that ``cell`` reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics read in ``cell``: those that list it."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]


def metric_module(name: str):
    """The module ``portbench/metrics/<name>.py``, or, where there is
    none, that of the name less its last dotted part (``device_idle.gat``
    is read by ``metrics/device_idle.py``)."""
    path = PACKAGE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = PACKAGE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return _load_module(path, f"portbench_metric_{name}")


def metric_reader(name: str):
    """``read(run)`` of the metric ``name``."""
    return metric_module(name).read


def task(name: str):
    """The module ``portbench/tasks/<name>.py``."""
    return _load_module(PACKAGE / "tasks" / f"{name}.py",
                        f"portbench_task_{name}")


def task_for(config: dict, traffic: dict):
    """The module that drives a cell of ``config`` under ``traffic``: the
    traffic's ``task``, or the configuration's ``model``."""
    return task(traffic.get("task", config["model"]))
