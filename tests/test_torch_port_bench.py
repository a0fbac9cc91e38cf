"""The port's benchmark entry point (``sgc_tpu_torch/bench.py``) and its
quickstart, on the CPU.

* The stdout contract: ``compact_summary`` keeps the tracked fields,
  drops the audit bulk and stays within ``COMPACT_MAX_CHARS`` (the
  reference's three checks of tests/test_bench_contract.py, plus the
  ``forms`` map at its fullest).
* The legs against the reference's ``bench.py`` at scale 0.02, the
  reference on committed admission rates (``SGC_TPU_NO_CALIBRATE=1``,
  as the port's CPU rates are) and its native LPA, both heads starting
  from the reference's ``_train_setup`` parameters (``params_from_jax``):
  edges, dense_frac and the resolved formulation bit for bit, the prep
  keys the port keeps; the uniform leg's propagated train rows (and the
  clustered leg's) within 1e-5 of max; the Newton fit's loss and train
  accuracy within rtol 1e-4; of the LBFGS oracle, chaotic at wd 1e-5
  (ROADMAP queue 3 item 6), only the gate's outcome.
* ``python -m sgc_tpu_torch.bench --device cpu`` and ``python -m
  sgc_tpu_torch.examples.quickstart --device cpu`` as processes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import bench as ref_bench
from sgc_tpu.train import loops as ref_loops

from sgc_tpu_torch import bench
from sgc_tpu_torch.models.sgc import params_from_jax
from sgc_tpu_torch.train import loops as port_loops

from test_bench_contract import _fat_out
from test_torch_port_slice import TOL, reference_native_lpa, rel_err

REPO = Path(__file__).resolve().parents[1]
SCALE = 0.02

# prep keys of the reference's LocalityPlan that the port does not carry:
# its page-fault probe and memory counters (utils/alloc.py, left out) and
# apply_s, a constant 0.0 there (folded into order_s)
REFERENCE_ONLY_PREP_KEYS = {
    "probe_s", "fault_mrate_before", "fault_mrate_after", "rss0_gb",
    "order_minflt_m", "subgraph_minflt_m", "split_minflt_m", "split_rss_gb",
    "apply_s", "pool_prewarm_s"}

# the reference's resolved formulation -> the port's counterpart
COUNTERPART = {"blockdense_pallas": "blockdense_kernel",
               "blockdense": "blockdense", "onehot": "onehot"}


# ----------------------------------------------------------- the contract

def _fullest_forms() -> dict:
    return {form: {"hops_s": 0.021714285714, "total_s": 0.0428213,
                   "dense_frac": 0.8504203, "prep_s": 4.0,
                   "parity_ok": True,
                   "roofline": {"dense": {"seconds": 0.011}},
                   "launches": {"blockdense_cells": 6, "csr_spmm": 6}}
            for form in bench.FORMS}


def _port_fat_out() -> dict:
    out = _fat_out()
    out.pop("hugealloc_installed")
    out["forms"] = _fullest_forms()
    out["legs"] = {"clustered": {"total_s": 0.03, "launches": {}}}
    return out


def test_compact_line_fits_driver_tail():
    line = json.dumps(bench.compact_summary(_port_fat_out(),
                                            "build/bench_details_torch.json"))
    assert len(line) <= bench.COMPACT_MAX_CHARS, (
        f"compact line {len(line)} chars exceeds the driver budget")


def test_compact_line_carries_driver_fields():
    c = json.loads(json.dumps(bench.compact_summary(_port_fat_out(),
                                                    "d.json")))
    assert c["metric"] == "reddit_sgc_precompute_train_s"
    assert (c["value"], c["unit"], c["vs_baseline"]) == (0.1674, "s", 16.129)
    assert c["edges_per_s"] == 145_000_000
    assert c["host_prep_s"] == 26.3
    assert c["uniform_auto_s"] == 0.5545
    assert c["vs_baseline_uniform"] == 4.869
    assert c["prep_seconds"]["split_s"] == 21.15
    assert c["train_parity"]["newton_train_acc"] == 0.5549
    assert c["details"] == "d.json"
    assert c["forms"] == {form: 0.02171 for form in bench.FORMS}
    # the audit bulk stays in the sidecar
    for key in ("projected_scaling", "roofline", "legs", "launches",
                "hugealloc_installed"):
        assert key not in c
    assert "comm_sweep" not in json.dumps(c)


def test_compact_line_minimal_input():
    out = {"metric": "m", "value": 1.0, "unit": "s", "vs_baseline": 2.7,
           "edges_per_s": 1}
    c = bench.compact_summary(out, "build/bench_details_torch.json")
    assert c["value"] == 1.0 and "prep_seconds" not in c
    assert "forms" not in c


def test_compact_keys_are_the_reference_less_hugealloc():
    """The port's line carries every key of the reference's line but
    ``hugealloc_installed``, and adds ``forms``."""
    out = _port_fat_out()
    got = set(bench.compact_summary(out, "d"))
    want = set(ref_bench.compact_summary(_fat_out(), "d"))
    assert got == want - {"hugealloc_installed"} | {"forms"}


# ------------------------------------------------------ environment knobs

def test_bad_topology_raises_system_exit(monkeypatch):
    monkeypatch.setenv("SGC_BENCH_TOPOLOGY", "ring")
    with pytest.raises(SystemExit, match="both|clustered|uniform"):
        bench.main(["--device", "cpu"])


@pytest.mark.parametrize("env,want", [
    (None, "auto"), ("blockdense_pallas", "blockdense_kernel"),
    ("blockdense", "blockdense"), ("onehot", "onehot"),
    ("blockdense_kernel", "blockdense_kernel")])
def test_formulation_env(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("SGC_BENCH_FORMULATION", raising=False)
    else:
        monkeypatch.setenv("SGC_BENCH_FORMULATION", env)
    assert bench.resolve_formulation(None) == want
    assert bench.resolve_formulation("blockdense_pallas") == \
        "blockdense_kernel"


# ------------------------------------------------ the legs, both packages

class _Capture:
    """Wraps a head fit, recording the rows (second argument) of each
    call; the packages import their fits at call time."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, *args, **kwargs):
        self.rows.append(args[1])
        return self.fn(*args, **kwargs)


def _last_rows(capture):
    for rows in reversed(capture.rows):
        if torch.is_tensor(rows):
            return rows.numpy()
        if not isinstance(rows, jax.core.Tracer):  # none from inside a jit
            return np.asarray(rows)
    raise AssertionError("no concrete rows captured")


@pytest.fixture(scope="module")
def legs():
    """Both packages' clustered, uniform-segment and uniform-auto legs at
    ``SCALE``, and the rows each fit was given."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGC_TPU_NO_CALIBRATE", "1")
        for var in ("SGC_BENCH_FORMULATION", "SGC_BENCH_TRAINER",
                    "SGC_BENCH_PROFILE_PLAN"):
            mp.delenv(var, raising=False)
        caps = {}
        for pkg, mod in (("ref", ref_loops), ("port", port_loops)):
            for fit in ("_lbfgs_linear_fit", "_newton_linear_fit"):
                caps[pkg, fit] = _Capture(getattr(mod, fit))
                mp.setattr(mod, fit, caps[pkg, fit])

        def rows(pkg, fit):
            r = _last_rows(caps[pkg, fit])
            caps[pkg, fit].rows.clear()
            return r

        # the reference's head at Reddit's shape (602 features, 41 classes)
        p0 = ref_bench._train_setup(np.zeros((1, 602), np.float32),
                                    np.array([40]), np.array([0]))[0]
        head = params_from_jax(np.asarray(p0.w), np.asarray(p0.b),
                               device="cpu")
        with reference_native_lpa():
            out["ref", "clustered"] = ref_bench.run_clustered_hybrid(SCALE)
        out["ref", "clustered_rows"] = rows("ref", "_newton_linear_fit")
        out["port", "clustered"] = bench.run_clustered_hybrid(
            SCALE, device="cpu", params0=head)
        out["port", "clustered_rows"] = rows("port", "_newton_linear_fit")

        udata = ref_bench.synthetic_reddit(SCALE)
        out["ref", "uniform"] = ref_bench.run_uniform_segment(SCALE,
                                                              data=udata)
        out["ref", "uniform_rows"] = rows("ref", "_lbfgs_linear_fit")
        pdata = bench.synthetic_reddit(SCALE)
        out["port", "uniform"] = bench.run_uniform_segment(
            SCALE, data=pdata, device="cpu", params0=head)
        out["port", "uniform_rows"] = rows("port", "_lbfgs_linear_fit")

        with reference_native_lpa():
            out["ref", "uniform_auto"] = ref_bench.run_clustered_hybrid(
                SCALE, data=udata, name="uniform-auto")
        out["port", "uniform_auto"] = bench.run_clustered_hybrid(
            SCALE, data=pdata, name="uniform-auto", device="cpu",
            params0=head)
    return out


@pytest.mark.parametrize("leg", ["clustered", "uniform", "uniform_auto"])
def test_leg_host_fields_bit_equal(legs, leg):
    ref, port = legs["ref", leg], legs["port", leg]
    assert port["edges"] == ref["edges"]
    assert port["n_features"] == ref["n_features"] == 602
    assert port["graph"].nnz == ref["graph"].nnz
    if leg == "uniform":
        return
    assert port["dense_frac"] == ref["dense_frac"]
    assert port["formulation"] == COUNTERPART[ref["formulation"]]
    assert set(port["prep_stages"]) == (set(ref["prep_stages"])
                                        - REFERENCE_ONLY_PREP_KEYS)
    assert port["admission_rates"] == ref["admission_rates"]


def test_clustered_leg_split_is_the_slice_tests(legs):
    """At the committed admission the headline leg's split is the one
    tests/test_torch_port_slice.py holds (42 cells at 0.02)."""
    port = legs["port", "clustered"]
    assert port["formulation"] == "blockdense"
    assert port["roofline"]["form"] == "pallas"
    assert port["roofline"]["remainder"]["edges"] == 17890
    assert port["roofline"]["dense"]["bytes"] > 0


@pytest.mark.parametrize("leg", ["uniform", "clustered"])
def test_leg_propagated_rows(legs, leg):
    got, want = legs["port", f"{leg}_rows"], legs["ref", f"{leg}_rows"]
    assert rel_err(got, want) <= TOL


def test_clustered_parity_gate_matches_reference(legs):
    ref = legs["ref", "clustered"]["train_parity"]
    port = legs["port", "clustered"]["train_parity"]
    assert set(port) == set(ref)
    np.testing.assert_allclose(port["newton_loss"], ref["newton_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(port["newton_train_acc"],
                               ref["newton_train_acc"], rtol=1e-4)
    assert port["chance_acc"] == ref["chance_acc"]
    assert port["parity_ok"] is ref["parity_ok"] is True
    assert port["converged_retry"] == ref["converged_retry"]
    assert port["trainer"] == ref["trainer"] == "newton"


def test_uniform_auto_leg_is_not_audited(legs):
    for pkg in ("ref", "port"):
        leg = legs[pkg, "uniform_auto"]
        assert leg["roofline"] == {} and leg["train_parity"] == {}


# ------------------------------------------------------- the processes

def _run(args, env_extra, timeout=240):
    # one intra-op thread, as the in-process port tests pin: beside the
    # suite's busy workers a process with a thread per core ran ~20x
    # slower (10 s alone, 170-240 s in the suite at scale 0.01)
    env = {**os.environ, "OMP_NUM_THREADS": "1", **env_extra}
    for var in ("SGC_BENCH_FORMULATION", "SGC_BENCH_TRAINER",
                "SGC_BENCH_TOPOLOGY"):
        env.pop(var, None)
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_bench_cli_on_cpu():
    details = REPO / "build" / "bench_details_torch.json"
    details.unlink(missing_ok=True)
    reference_sidecar = (REPO / "bench_details.json").read_bytes()
    r = _run(["sgc_tpu_torch.bench", "--device", "cpu"],
             {"SGC_BENCH_SCALE": "0.01"})
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) <= bench.COMPACT_MAX_CHARS
    c = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "edges_per_s",
                "formulation", "dense_frac", "host_prep_s", "prep_seconds",
                "train_parity", "forms", "uniform_segment_s",
                "vs_baseline_uniform_segment", "uniform_edges_per_s",
                "vs_baseline_uniform", "uniform_auto_s", "details"):
        assert key in c, key
    assert c["metric"] == "reddit_sgc_precompute_train_s"
    assert c["details"] == "build/bench_details_torch.json"
    assert c["train_parity"]["parity_ok"] is True
    assert set(c["forms"]) == set(bench.FORMS)
    side = json.loads(details.read_text())
    assert side["card"] is None and side["device"] == "cpu"
    assert set(side["legs"]) == {"clustered", "uniform_segment",
                                 "uniform_auto"}
    for form in bench.FORMS:
        f = side["forms"][form]
        assert f["parity_ok"] is True and f["hops_s"] > 0
        # the plain versions launch no kernel
        assert set(f["launches"].values()) == {0}
    assert side["forms"]["onehot"]["roofline"] == {}
    assert set(side["roofline"]) >= {"dense", "remainder"}
    ps = side["projected_scaling"]
    assert ps["sharded_blockdense_plan"]["n_parts"] == 8
    assert ps["comm_sweep"]["rows"] and "fabric_note" in ps
    # the reference's committed sidecar is never written by the port
    assert (REPO / "bench_details.json").read_bytes() == reference_sidecar


def test_quickstart_on_cpu():
    r = _run(["sgc_tpu_torch.examples.quickstart", "--device", "cpu"], {},
             timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    assert out[0] == "backend: cpu, devices: 1"
    starts = ("SGC   K=2 : test acc", "APPNP K=16: test acc", "sharded: 1 "
              "parts", "locality: ", "wd grid (8 heads", "served predictions "
              "for 10 nodes")
    assert len(out) == 1 + len(starts)
    for line, start in zip(out[1:], starts):
        assert line.startswith(start), line
    sgc_acc = float(out[1].split("test acc ")[1].split()[0])
    assert sgc_acc >= 0.9


def test_bench_uniform_topology_heads_the_line(monkeypatch, capsys):
    """``SGC_BENCH_TOPOLOGY=uniform``: the uniform segment leg heads the
    line (the reference's ``head = clustered or uniform``), with no
    clustered field and no forms."""
    monkeypatch.setenv("SGC_BENCH_TOPOLOGY", "uniform")
    monkeypatch.setenv("SGC_BENCH_SCALE", "0.01")
    for var in ("SGC_BENCH_FORMULATION", "SGC_BENCH_TRAINER"):
        monkeypatch.delenv(var, raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    c = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert c["value"] == c["uniform_segment_s"]
    assert c["uniform_auto_s"] > 0
    for key in ("forms", "train_parity", "dense_frac", "prep_seconds"):
        assert key not in c
