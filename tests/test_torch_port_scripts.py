"""The ported experiments of ``sgc_tpu_torch/scripts/`` against the
reference's unchanged ``scripts/exp_*.py`` (part 1: the topology sweep,
the head's cost, kernel A's cell order, and the rules every new module
keeps); ``test_torch_port_scripts_geometry.py`` holds the onehot
geometry and the beyond-one-device fit.

Each reference script runs through ``runpy`` as ``__main__`` at a small
size (argv and its environment knobs), with ``SGC_TPU_NO_CALIBRATE`` set,
its JAX compile cache in a temporary directory and the JAX settings it
changes restored. Where the port must agree with a value the script
computes but does not print, a function of the reference's module is
wrapped to record it (``sync`` records what the script synchronizes on;
``LocalityPlan.propagate_train`` its propagated rows). Host results must
match bit for bit; outputs within the tolerance each test states. Torch
is pinned to one intra-op thread, as in the other port test files.
"""

import ast
import contextlib
import io
import json
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache
from jax.experimental import pallas as pl

from test_torch_port_slice import reference_native_lpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
PORT_SCRIPTS = ("exp_topology_sweep", "exp_beyond_device",
                "exp_beyond_stages", "exp_newton_head", "exp_lbfgs_cost",
                "exp_pad_study", "exp_crossover", "exp_flat_sweep",
                "exp_hybrid_sweep", "exp_super_rows")
_JAX_SETTINGS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_compile_time_secs")
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def run_ref(script: str, argv: list, cache_dir, env=None, patches=(),
            interpret: bool = False) -> tuple[str, int]:
    """Run ``scripts/<script>`` as ``__main__``; returns ``(stdout +
    stderr, exit code)``. ``patches``: ``(object, name, value)`` set for
    the run; ``interpret`` forces its Pallas calls to interpret mode (the
    CPU cannot compile them)."""
    saved = {k: getattr(jax.config, k) for k in _JAX_SETTINGS}
    buf = io.StringIO()
    code = 0
    with pytest.MonkeyPatch.context() as mp:
        if interpret:
            orig = pl.pallas_call
            mp.setattr(pl, "pallas_call",
                       lambda *a, **kw: orig(*a, **{**kw,
                                                    "interpret": True}))
        for obj, name, value in patches:
            mp.setattr(obj, name, value)
        mp.setenv("SGC_TPU_COMPILE_CACHE", str(cache_dir))
        mp.setenv("SGC_TPU_NO_CALIBRATE", "1")
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        mp.setattr(sys, "argv", [script, *argv])
        try:
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(buf), reference_native_lpa():
                runpy.run_path(os.path.join(SCRIPTS, script),
                               run_name="__main__")
        except SystemExit as e:
            code = int(e.code or 0)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
            compilation_cache.reset_cache()
    return buf.getvalue(), code


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def recording_sync(store: list):
    """A stand-in for ``sgc_tpu.utils.profiling.sync`` that records
    what it is given."""
    from sgc_tpu.utils import profiling

    real = profiling.sync

    def sync(tree):
        real(tree)
        store.append(np.asarray(tree))

    return sync


# ------------------------------------------------------- the topology sweep

TOPO_SCALE = "0.01"


@pytest.fixture(scope="module")
def topology(tmp_path_factory):
    from sgc_tpu.utils import profiling
    from sgc_tpu_torch.scripts import exp_topology_sweep as port

    synced = []
    text, code = run_ref("exp_topology_sweep.py",
                         ["--scale", TOPO_SCALE, "--quick"],
                         tmp_path_factory.mktemp("cache"),
                         patches=[(profiling, "sync",
                                   recording_sync(synced))])
    results = []
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rows = port.run(float(TOPO_SCALE), "cpu", quick=True, reps=1,
                        on_config=results.append)
    return {"ref_rows": json_lines(text), "ref_code": code,
            "synced": synced, "rows": rows, "results": results}


def test_topology_sweep_host_results_match_reference(topology):
    """Each config's name, nnz, formulation and dense fraction are the
    reference's; every extra field is there."""
    ref, rows = topology["ref_rows"], topology["rows"]
    assert [r["config"] for r in rows] == [r["config"] for r in ref]
    assert len(rows) == 4
    for got, want in zip(rows, ref):
        for k in ("config", "nnz", "formulation", "dense_frac"):
            assert got[k] == want[k], (k, got, want)
        assert set(want) <= set(got)
        for k in ("auto_uncal_ms", "onehot_ms", "auto_uncal_dense_frac",
                  "onehot_dense_frac", "segment_ms", "auto_ms"):
            assert k in got


def test_topology_sweep_hops_match_reference(topology):
    """The segment hops and the auto plan's hops agree with the
    reference's within 1e-5 (the reference synchronizes on a warm run and
    two timed runs of each, in that order), and so do the uncalibrated
    plan's (on the CPU the same admission). The onehot plan's rows (f32
    values, where the block-dense cells hold bf16 ones), taken back to
    the loader's numbering, agree with the segment hops within 1e-5."""
    synced = topology["synced"]
    assert len(synced) == 6 * len(topology["rows"])
    for k, res in enumerate(topology["results"]):
        seg_ref, auto_ref = synced[6 * k], synced[6 * k + 3]
        out = res["outputs"]
        assert rel_err(out["segment"].numpy(), seg_ref) <= TOL
        assert rel_err(out["auto"].numpy(), auto_ref) <= TOL
        assert rel_err(out["auto_uncal"].numpy(), auto_ref) <= TOL
        plan = res["plans"]["onehot"]
        old = plan.order[plan.idx_train]
        onehot = out["onehot"].numpy()[np.argsort(old, kind="stable")]
        assert rel_err(onehot, out["segment"].numpy()) <= TOL


def test_topology_sweep_exit_code_follows_the_verdict(topology, capsys,
                                                      monkeypatch):
    """``--quick`` exits 1 exactly when a config fails auto <= segment *
    1.15, in the reference (its run above) and in the port."""
    from sgc_tpu_torch.scripts import exp_topology_sweep as port

    assert topology["ref_code"] == int(
        any(not r["pass"] for r in topology["ref_rows"]))
    argv = ["--scale", "0.005", "--quick", "--device", "cpu"]
    code = port.main(argv)
    rows = json_lines(capsys.readouterr().out)
    assert [r["config"] for r in rows] == [n for n, _ in port.grid(True)]
    assert code == int(any(not r["pass"] for r in rows))
    # a margin no config can meet fails it (one config, for time)
    monkeypatch.setattr(port, "MARGIN", -1.0)
    monkeypatch.setattr(port, "grid", lambda quick: [(port.UNIFORM, None)])
    assert port.main(argv) == 1
    rows = json_lines(capsys.readouterr().out)
    assert len(rows) == 1 and not rows[0]["pass"]


def test_topology_sweep_grid_is_the_references():
    from sgc_tpu_torch.scripts import exp_topology_sweep as port

    full = [name for name, _ in port.grid()]
    assert len(full) == 12 and full[-1] == "uniform_structureless"
    assert "intra0.65_comm10_sq" in full and "intra0.5_comm200_powerlaw" \
        in full
    assert [name for name, _ in port.grid(quick=True)] == [
        "intra0.5_comm200_sq", "intra0.85_comm50_sq",
        "intra0.85_comm50_powerlaw", "uniform_structureless"]


# ------------------------------------------------------------------ the head

NEWTON_SCALE = "0.01"


@pytest.fixture(scope="module")
def newton(tmp_path_factory):
    """The reference's script with its LBFGS line recorded and reported
    as loss 0, so its Böhning loop never meets parity and prints all 20
    iterations; its propagated rows and labels recorded."""
    from sgc_tpu.graph import locality
    from sgc_tpu.train import loops

    seen = {}
    real_prop = locality.LocalityPlan.propagate_train
    real_lbfgs = loops._lbfgs_linear_fit

    def propagate_train(self, *a, **kw):
        out = real_prop(self, *a, **kw)
        seen["tr"] = np.asarray(out)
        seen["y"] = np.asarray(self.labels)[np.asarray(self.idx_train)]
        return out

    def lbfgs(params, tr, y, *a):
        p, loss = real_lbfgs(params, tr, y, *a)
        logits = tr @ p.w + p.b
        seen["lbfgs"] = (float(loss), float(
            (jnp.argmax(logits, 1) == y).mean()))
        return p, jnp.asarray(0.0, jnp.float32)

    text, _ = run_ref("exp_newton_head.py", [NEWTON_SCALE],
                      tmp_path_factory.mktemp("cache"),
                      patches=[(locality.LocalityPlan, "propagate_train",
                                propagate_train),
                               (loops, "_lbfgs_linear_fit", lbfgs)])
    iters = [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
        r"newton iter\s+(\d+): loss ([0-9.]+) acc ([0-9.]+)", text)]
    return {**seen, "iters": iters, "text": text}


def test_newton_head_matches_reference_step_by_step(newton):
    """From the reference's propagated rows, the port's Böhning losses
    agree with the reference's printed ones (6 decimals) within 1e-5
    relative over all 20 iterations, and the accuracies to the printed
    4 decimals."""
    from sgc_tpu_torch.scripts import exp_newton_head as port

    tr = torch.from_numpy(newton["tr"].copy())
    y = torch.from_numpy(newton["y"].copy())
    C = int(newton["y"].max()) + 1
    got = port.newton_to_parity(tr, y, C, 0.0, 1.0, emit=lambda s: None)
    ref = newton["iters"]
    assert len(ref) == port.MAX_ITER == len(got["iters"])
    assert got["parity_iter"] is None
    for (it, loss, acc), (rit, rloss, racc) in zip(got["iters"], ref):
        assert it == rit
        assert abs(loss - rloss) <= TOL * abs(rloss) + 5e-7, (it, loss,
                                                               rloss)
        assert abs(acc - racc) <= 5e-5 + 1.0 / len(newton["y"]), it


def test_newton_head_parity_iteration_is_the_references(newton):
    """Against the oracle's true loss and accuracy (the reference's own
    LBFGS line at the script's weight decay 0), the port stops at the
    iteration where the reference's printed trajectory first meets
    them."""
    from sgc_tpu_torch.scripts import exp_newton_head as port

    loss_lb, acc_lb = newton["lbfgs"]
    want = next((it for it, loss, acc in newton["iters"]
                 if loss <= loss_lb and acc >= acc_lb), None)
    tr = torch.from_numpy(newton["tr"].copy())
    y = torch.from_numpy(newton["y"].copy())
    got = port.newton_to_parity(tr, y, int(newton["y"].max()) + 1, loss_lb,
                                acc_lb, emit=lambda s: None)
    assert got["parity_iter"] == want and want is not None


def test_newton_head_lbfgs_line_matches_reference_at_wd_1e2(newton):
    """The script's LBFGS line through the port's oracle against the
    reference's ``_lbfgs_linear_fit`` on the same rows and start at weight
    decay 1e-2 (at the script's 0 both runs are chaotic, ROADMAP queue 3
    item 6), within test_lbfgs_oracle_matches_reference's 5e-4."""
    from sgc_tpu.models.sgc import init_sgc as ref_init
    from sgc_tpu.train.loops import _lbfgs_linear_fit as ref_lbfgs
    from sgc_tpu_torch.models.sgc import params_from_jax
    from sgc_tpu_torch.scripts import exp_newton_head as port

    tr, y = newton["tr"], newton["y"]
    C = int(y.max()) + 1
    p0 = ref_init(jax.random.PRNGKey(42), tr.shape[1], C, bias=True)
    _, ref_loss = ref_lbfgs(p0, jnp.asarray(tr), jnp.asarray(y),
                            jnp.asarray(1e-2, jnp.float32),
                            jnp.ones((C,), jnp.float32), 2, False, False, 1.0)
    _, loss, acc = port.lbfgs(
        torch.from_numpy(tr.copy()), torch.from_numpy(y.copy()),
        params_from_jax(np.asarray(p0.w), np.asarray(p0.b), device="cpu"),
        1e-2)
    assert abs(loss - float(ref_loss)) <= 5e-4 * abs(float(ref_loss))
    assert 0.0 < acc <= 1.0


LBFGS_SHAPE = (2000, 32, 5)


def test_lbfgs_cost_matches_reference_at_every_history_size(tmp_path):
    """At a small shape, each history size's fit from the reference's
    start ends at the reference's loss within 5e-4
    (tests/test_lbfgs_torch_oracle.py's tolerance); the port prints the
    reference's line per size."""
    from sgc_tpu.models.sgc import init_sgc as ref_init
    from sgc_tpu_torch.models.sgc import params_from_jax
    from sgc_tpu_torch.scripts import exp_lbfgs_cost as port

    n, f, c = LBFGS_SHAPE
    saved = {k: getattr(jax.config, k) for k in _JAX_SETTINGS}
    synced = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SGC_TPU_COMPILE_CACHE", str(tmp_path))
        try:
            g = runpy.run_path(os.path.join(SCRIPTS, "exp_lbfgs_cost.py"),
                               run_name="reference_lbfgs_cost")
            glob = g["main"].__globals__
            glob.update(N_TRAIN=n, F=f, C=c, REPS=1,
                        sync=lambda out: synced.append(np.asarray(out)))
            with contextlib.redirect_stdout(io.StringIO()):
                glob["main"]()
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
            compilation_cache.reset_cache()
    x, y = port.make_inputs(n, f, c)
    p0 = ref_init(jax.random.PRNGKey(0), f, c, bias=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = port.run(torch.from_numpy(x), torch.from_numpy(y),
                       params_from_jax(np.asarray(p0.w), np.asarray(p0.b),
                                       device="cpu"), reps=1)

    def loss(flat):
        w, b = flat[: f * c].reshape(f, c), flat[f * c:]
        lg = x.astype(np.float64) @ w + b
        lg -= lg.max(axis=1, keepdims=True)
        return float((np.log(np.exp(lg).sum(axis=1))
                      - lg[np.arange(n), y]).mean())

    assert len(synced) == 2 * len(port.HISTORY_SIZES)
    for k, m in enumerate(port.HISTORY_SIZES):
        want = loss(synced[2 * k + 1])
        assert abs(loss(got[m]["flat"].numpy()) - want) <= 5e-4 * want, m
        assert 1 <= got[m]["iters"] <= port.ITERS
    assert re.findall(r"m=\s*(\d+): +[0-9.]+ ms for \d+ iters \([0-9.]+ "
                      r"ms/iter\)", buf.getvalue()) == ["1", "5", "40"]


# ----------------------------------------------------- rules of every module

def _module_ast(name):
    path = os.path.join(REPO, "sgc_tpu_torch", "scripts", f"{name}.py")
    return ast.parse(open(path).read())


@pytest.mark.parametrize("name", PORT_SCRIPTS)
def test_script_swallows_no_failure(name):
    """No ``except`` in the module: every kernel call and host step is a
    plain call (the reference printed its Mosaic failures as data
    points)."""
    handlers = [n.lineno for n in ast.walk(_module_ast(name))
                if isinstance(n, ast.ExceptHandler)]
    assert handlers == [], f"{name}: except at lines {handlers}"


@pytest.mark.parametrize("name", PORT_SCRIPTS)
def test_script_imports_neither_jax_nor_reference(name):
    imports = re.compile(r"^\s*(import|from)\s+(jax|sgc_tpu)\b(?!_torch)",
                         re.M)
    path = os.path.join(REPO, "sgc_tpu_torch", "scripts", f"{name}.py")
    assert imports.findall(open(path).read()) == []


def _boom(*a, **kw):
    raise RuntimeError("kernel failed")


@pytest.mark.parametrize("case", ["crossover_flat", "crossover_hybrid",
                                  "flat_sweep", "hybrid_sweep",
                                  "pad_study_rcm"])
def test_a_failure_raises(case, monkeypatch):
    """Where the reference caught the exception and printed an error row,
    the port's run raises it."""
    from sgc_tpu_torch.data.synthetic import synthetic_reddit
    from sgc_tpu_torch.scripts import (
        exp_crossover,
        exp_flat_sweep,
        exp_hybrid_sweep,
        exp_pad_study,
    )

    graph, x, _, _ = synthetic_reddit(0.004)
    xt = torch.as_tensor(x)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="kernel failed"):
        if case == "crossover_flat":
            monkeypatch.setattr(exp_crossover, "spmm_tiled_flat", _boom)
            exp_crossover.run_scale(0.004, "uniform", "cpu", 1)
        elif case == "crossover_hybrid":
            monkeypatch.setattr(exp_crossover, "spmm_hybrid_split", _boom)
            exp_crossover.run_scale(0.004, "uniform", "cpu", 1)
        elif case == "flat_sweep":
            monkeypatch.setattr(exp_flat_sweep, "spmm_tiled_flat", _boom)
            exp_flat_sweep.run(graph, xt, 1)
        elif case == "hybrid_sweep":
            monkeypatch.setattr(exp_hybrid_sweep, "spmm_hybrid_split", _boom)
            exp_hybrid_sweep.run(graph, xt, 1)
        else:
            monkeypatch.setattr(exp_pad_study, "rcm_order", _boom)
            exp_pad_study.run(graph)
    assert '"error"' not in out.getvalue()


def test_feature_tile_axis_collapses(monkeypatch):
    """Kernel C has no feature tile: the hybrid sweep times each (R, W)
    split once, a config differing only in ``ft`` repeats that timing and
    names it (``same_as``); the crossover and flat sweep time one call a
    precision and tiling."""
    from sgc_tpu_torch.data.synthetic import synthetic_reddit
    from sgc_tpu_torch.scripts import exp_flat_sweep, exp_hybrid_sweep

    calls = []
    real = exp_hybrid_sweep.spmm_hybrid_split
    monkeypatch.setattr(exp_hybrid_sweep, "spmm_hybrid_split",
                        lambda s, *a, **kw: calls.append(
                            (s.tiled.row_block, s.tiled.stripe))
                        or real(s, *a, **kw))
    graph, x, _, _ = synthetic_reddit(0.004)
    with contextlib.redirect_stdout(io.StringIO()):
        rows = exp_hybrid_sweep.run(graph, torch.as_tensor(x), 1)
    assert [(r["rb"], r["w"], r["ft"]) for r in rows] == list(
        exp_hybrid_sweep.CONFIGS)
    assert len(set(calls)) == 5 and len(calls) == 5 * 2   # warm + 1 run
    assert rows[1]["same_as"] == [512, 512, 256]
    assert rows[1]["hop_s"] == rows[0]["hop_s"]
    assert all("same_as" not in r for r in rows if r is not rows[1])
    assert {c[3] for c in exp_flat_sweep.CONFIGS} == {"f32"}


def test_tpu_figures_are_named_as_the_tpus():
    """The TPU constants survive only under TPU names, with the card's
    figures beside them."""
    from sgc_tpu_torch.parallel import staging
    from sgc_tpu_torch.scripts import exp_beyond_device, exp_pad_study

    assert exp_pad_study.TPU_V5E_ONEHOT_FLOPS == 142e12
    assert exp_beyond_device.V5E_HBM_BYTES is staging.V5E_HBM_BYTES
    figures = exp_pad_study.device_figures(torch.device("cpu"))
    assert figures["hbm_gbps"] == 3350.0 and "memory_bytes" not in figures
    for name in PORT_SCRIPTS:
        path = os.path.join(REPO, "sgc_tpu_torch", "scripts", f"{name}.py")
        for ln in open(path).read().splitlines():
            if re.search(r"142e12|16 \* 1024|197e12", ln):
                assert "TPU" in ln or "tpu" in ln or "v5e" in ln, (name, ln)
