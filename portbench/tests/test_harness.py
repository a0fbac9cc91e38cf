"""Whole runs of each cell on the CPU at a small scale (the chip's look
skipped): a sound run is correct; a run with the timed path broken
underneath, once for each fault the cell can have, is not; and the
control (the reference in TF32 in the program's place) and the planted
faults read over the cell's limits."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import control, spec
from portbench.tests.conftest import SCALE, SEED

CELLS = ["sgc-reddit.fit-clustered", "gat-reddit.train"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(run_small, bench, name):
    line = run_small(name, seconds=0.5)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"] for m in bench.end_to_end(name)}
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _unchanged_head(monkeypatch):
    import sgc_tpu_torch.train.loops as loops
    from sgc_tpu_torch.models.sgc import SGC

    def fit(model, *args, **kwargs):
        return SGC(model.w.detach().clone(), model.b.detach().clone()), 0.0

    monkeypatch.setattr(loops, "train_linear", fit)


def _half_batch_head(monkeypatch):
    import sgc_tpu_torch.train.loops as loops

    real = loops.train_linear

    def fit(model, rows, y, **kwargs):
        return real(model, rows[::2], y[::2], **kwargs)

    monkeypatch.setattr(loops, "train_linear", fit)


def _altered_row(monkeypatch):
    from sgc_tpu_torch.graph.locality import LocalityPlan

    real = LocalityPlan.khop_traceable

    def traceable(self, *args, **kwargs):
        khop, dev_args = real(self, *args, **kwargs)

        def broken(x, a):
            out = khop(x, a).clone()
            out[0] = out[1]
            return out

        return broken, dev_args

    monkeypatch.setattr(LocalityPlan, "khop_traceable", traceable)


def _unchanged_state(monkeypatch):
    real = torch.optim.Adam.step

    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        kept = [p.detach().clone() for p in params]
        real(self, closure)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p.copy_(k)

    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _half_batch_loss(monkeypatch):
    import sgc_tpu_torch.train.loops as loops

    real = loops.node_cross_entropy

    def loss(logits, labels, weights):
        w = weights.clone()
        w[torch.nonzero(weights)[1::2, 0]] = 0.0
        return real(logits, labels, w)

    monkeypatch.setattr(loops, "node_cross_entropy", loss)


def _altered_logits(monkeypatch):
    import sgc_tpu_torch.models.gat as gat

    real = gat.multi_head_gat

    def layer(*args, concat=True, **kwargs):
        out = real(*args, concat=concat, **kwargs)
        if concat:
            return out
        out = out.clone()
        out[:10] = out[10:20]   # at SEED, train rows among them
        return out

    monkeypatch.setattr(gat, "multi_head_gat", layer)


@pytest.mark.parametrize("name,fault", [
    ("sgc-reddit.fit-clustered", _unchanged_head),
    ("sgc-reddit.fit-clustered", _half_batch_head),
    ("sgc-reddit.fit-clustered", _altered_row),
    ("gat-reddit.train", _unchanged_state),
    ("gat-reddit.train", _half_batch_loss),
    ("gat-reddit.train", _altered_logits),
], ids=["sgc-unchanged", "sgc-half-batch", "sgc-altered-row",
        "gat-unchanged", "gat-half-batch", "gat-altered-logits"])
def test_broken_run_is_not_correct(run_small, monkeypatch, name, fault):
    fault(monkeypatch)
    line = run_small(name)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_read_over_the_limits(bench, name):
    """The readings that ``portbench.control`` takes on the card at the
    cell's size, here at :data:`SCALE` on the CPU: the control fails
    one of the cell's numbers, and so does each fault."""
    torch.set_num_threads(2)
    cell = bench.workload(name)
    config = bench.config(cell["config"])
    traffic = copy.deepcopy(bench.traffic(cell["traffic"]))
    traffic["graph"]["scale"] = SCALE
    model = spec.Benchmark().config(cell["config"])["model"]
    upper = control.UPPER[model](config, traffic, SEED,
                                 torch.device("cpu"))
    limits = config["limits"]

    def fails(nums):
        return any(v > limits[k] for k, v in nums.items())

    assert fails(upper["control"]), upper["control"]
    for fault, nums in upper["faults"].items():
        assert fails(nums), (fault, nums)
