"""The ported beyond-one-device experiments
(``sgc_tpu_torch/scripts/exp_beyond_{device,stages}.py``) against the
reference's unchanged ``scripts/exp_beyond_device.py``, and every ported
experiment's ``main`` on the CPU.

The reference's graph and row provider must be the port's bit for bit.
Its fit runs on the virtual 8-device mesh (``tests/conftest.py``) at a
small ``scale`` with ``fit_sharded`` wrapped to record the head; the
port's runs on 2 and on 4 gloo ranks (``SGC_TPU_TORCH_CPU_RANKS``) from
the reference's initial head, at the script's weight decay 0 (where the
reference's mesh-scaled gradient, ROADMAP queue 3 item 17, is hidden by
Adam), within ``tests/test_torch_port_fit_sharded.py``'s tolerances:
losses rtol 1e-4, W and b rtol 1e-3 (atol 1e-5), train accuracy 0.02.
"""

import contextlib
import importlib
import io
import os
import re
import runpy

import jax
import numpy as np
import pytest
import torch

from test_torch_port_scripts import SCRIPTS

BEYOND_SCALE = 0.001      # 4,096 nodes (the floor) x 64 features
BEYOND_EPOCHS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_module():
    return runpy.run_path(os.path.join(SCRIPTS, "exp_beyond_device.py"),
                          run_name="reference_beyond_device")


def test_build_graph_matches_reference(ref_module):
    from sgc_tpu_torch.scripts import exp_beyond_device as port

    want = ref_module["build_graph"](4096, 4, 8)
    got = port.build_graph(4096, 4, 8)
    assert got.nnz == want.nnz and got.shape == tuple(want.shape)
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, k)[: got.nnz],
                                      np.asarray(getattr(want, k))[
                                          : want.nnz])


def test_staged_rows_match_reference(ref_module, monkeypatch):
    """The provider's rows (computed a few rows at a time in the port)
    and labels are the reference's bit for bit, over any row range."""
    from sgc_tpu_torch.scripts import exp_beyond_device as port

    monkeypatch.setattr(port, "PROVIDER_ROWS", 300)
    want = ref_module["class_signal_features"](4096, 64, 16)
    got = port.class_signal_features(4096, 64, 16)
    assert got.shape == tuple(want.shape) and got.dtype == want.dtype
    for start, stop in ((0, 4096), (1000, 2301), (4095, 4096)):
        np.testing.assert_array_equal(got(start, stop), want(start, stop))
        np.testing.assert_array_equal(got.labels(start, stop),
                                      want.labels(start, stop))
    assert port.sizes(BEYOND_SCALE) == (4096, 64)
    assert port.sizes(1.0) == (2_400_000, 2_048)


@pytest.fixture(scope="module")
def ref_fit(ref_module):
    from sgc_tpu.parallel import fit

    seen = {}
    real = fit.fit_sharded

    def record(*a, **kw):
        params, report = real(*a, **kw)
        seen.update(w=np.asarray(params.w), b=np.asarray(params.b),
                    report=report, kw=kw)
        return params, report

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fit, "fit_sharded", record)
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            out = ref_module["main"](scale=BEYOND_SCALE,
                                     epochs=BEYOND_EPOCHS)
    return {**seen, "json": out}


@pytest.mark.parametrize("ranks", [2, 4])
def test_beyond_device_fit_matches_reference(ref_fit, ranks, monkeypatch):
    from sgc_tpu.parallel.mesh import make_mesh as ref_mesh
    from sgc_tpu.parallel.train import init_sharded_state
    from sgc_tpu_torch.parallel.train import state_arrays
    from sgc_tpu_torch.scripts import exp_beyond_device as port

    monkeypatch.setenv("SGC_TPU_TORCH_CPU_RANKS", str(ranks))
    init = state_arrays(init_sharded_state(
        ref_mesh(1, 1), jax.random.PRNGKey(42), 64, port.N_CLASSES, 0.2,
        0.0))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        out = port.run(BEYOND_SCALE, BEYOND_EPOCHS, "cpu", init_state=init)
    w, b, report = out["_head"]
    ref = ref_fit["report"]
    np.testing.assert_allclose(report["loss_history"], ref.loss_history,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w, ref_fit["w"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(b, ref_fit["b"], rtol=1e-3, atol=1e-5)
    assert abs(report["train_accuracy"] - ref.train_accuracy) <= 0.02
    want = ref_fit["json"]
    for k in ("n_nodes", "n_features", "n_edges", "feature_gb",
              "feature_gib", "exceeds_v5e_hbm", "working_set_gib_2hop",
              "epochs", "col_chunk", "edge_chunk"):
        assert out[k] == want[k], k
    assert out["n_devices"] == ranks and out["transport"] == "gloo"
    assert out["exceeds_device_memory"] is None     # the CPU has no HBM
    assert ref_fit["kw"]["col_chunk"] == port.col_chunk_for(64)
    assert ref_fit["kw"]["edge_chunk"] == port.EDGE_CHUNK


def test_exceeds_device_memory_reads_the_rank_device():
    """At the reference's defaults the features exceed the v5e's 16 GiB
    and not an 80 GB card's; the report takes the card's memory from the
    device it is given (a meta tile holds no memory)."""
    from types import SimpleNamespace

    from sgc_tpu_torch.parallel import staging
    from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS
    from sgc_tpu_torch.scripts import exp_beyond_device as port

    n, f = port.sizes(1.0)
    mesh = SimpleNamespace(shape={NODES_AXIS: 1, FEAT_AXIS: 1}, size=1)
    tile = torch.empty((n, f), device="meta")
    rep = staging.sharding_report(mesh, tile, "cpu")
    assert rep["global_gb"] == round(n * f * 4 / 1e9, 2) == 19.66
    assert rep["exceeds_v5e_hbm"] is True
    assert rep["exceeds_device_memory"] is None
    props = SimpleNamespace(total_memory=80 * 10**9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "get_device_properties", lambda d: props)
        rep = staging.sharding_report(mesh, tile, "cuda:0")
    assert rep["exceeds_device_memory"] is False and rep["fits_per_device"]
# ------------------------------------------------------------ the mains

_F = r"[0-9.e+-]+"
MAIN_RUNS = {
    "exp_newton_head": (["0.005"], {}, [
        rf"n=\d+ F=602 C=\d+", rf"LBFGS 2 epochs \(40 iters\): loss {_F} "
        rf"train-acc {_F}  \[{_F}s incl first call\]",
        rf"newton iter  1: loss {_F} acc {_F}.*",
        rf"warm: LBFGS {_F} ms, .*"]),
    "exp_pad_study": (["--scale", "0.005"], {}, [
        r'device: \{.*"hbm_gbps": 3350\.0.*', r"nodes=\d+ edges=\d+",
        r'\{"order": "rcm", "rb": 2048, "w": 2048, .*"tpu_v5e_proj_hop_s"'
        r'.*"c_bound_ms".*', r"BEST: .*"]),
    "exp_crossover": (["--scales", "0.004", "--repeats", "1"], {}, [
        r'\{"scale": 0\.004, "topology": "uniform", "impl": "segment", .*',
        r'\{.*"impl": "tiled_flat_bf16", .*"rel_err".*',
        r'\{.*"impl": "hybrid", "rb": 1024, "w": 1024, .*']),
    "exp_flat_sweep": (["--scale", "0.004", "--repeats", "1"], {}, [
        rf"xla_segment_s={_F} \({_F}M edges/s\)",
        r'\{"rb": 2048, "w": 2048, "c": 1024, "prec": "f32", .*',
        r"BEST: .*", r'\{.*"prec": "bf16", .*']),
    "exp_hybrid_sweep": ([], {"SGC_BENCH_SCALE": "0.004"}, [
        r"graph ready: \d+ edges, F=602",
        r'\{"rb": 1024, "w": 1024, "ft": 128, .*"hop_s".*', r"BEST: .*"]),
    "exp_super_rows": ([], {"SGC_SUPER_SCALE": "0.01"}, [
        r'\{"scale": 0\.01, "rows": \{"None": .*"S8G4": .*"best": .*']),
    "exp_lbfgs_cost": ([], {}, [
        rf"m=  1: +{_F} ms for \d+ iters \({_F} ms/iter\)"]),
    "exp_beyond_device": ([], {"SGC_BEYOND_SCALE": "0.001",
                               "SGC_BEYOND_EPOCHS": "1"}, [
        r'\{"peak_host_rss_gib": .*"exceeds_v5e_hbm": false, .*'
        r'"exceeds_device_memory": null, .*']),
    "exp_beyond_stages": ([], {"SGC_BEYOND_SCALE": "0.001"}, [
        r"start +rss +[0-9.]+ GiB  t\+ +\d+s",
        r"hop2 +rss .*\(max over ranks .*\)",
        r"final logits \(4096, 16\) +rss .*"]),
}


@pytest.mark.parametrize("name", sorted(MAIN_RUNS))
def test_script_main_runs_on_the_cpu(name, capsys, monkeypatch):
    """``python -m sgc_tpu_torch.scripts.<name> ... --device cpu`` at a
    small size: exit code 0 and the reference's lines with their fields
    (``exp_lbfgs_cost`` at a shape shrunk in place). The topology
    sweep's exit code follows its timing verdict:
    ``test_torch_port_scripts.py::test_topology_sweep_exit_code_follows_the_verdict``
    runs its main."""
    argv, env, patterns = MAIN_RUNS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mod = importlib.import_module(f"sgc_tpu_torch.scripts.{name}")
    if name == "exp_lbfgs_cost":
        monkeypatch.setattr(mod, "N_TRAIN", 512)
        monkeypatch.setattr(mod, "N_FEATURES", 16)
        monkeypatch.setattr(mod, "REPS", 1)
    assert mod.main([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    for pat in patterns:
        assert any(re.fullmatch(pat, ln) for ln in lines), (pat, lines)
