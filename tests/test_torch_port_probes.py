"""The ported TPU experiment probes (``sgc_tpu_torch/scripts/``) and their
kernels' plain versions (E ``ops/probe_copy.py``, F ``ops/row_gather.py``,
G ``ops/edge_accumulate.py``, H ``ops/blockdense_int8.py``) against the
reference scripts' own Pallas kernels.

Each reference script runs unchanged through ``runpy``, at small sizes
passed through ``sys.argv``, with ``pallas_call`` forced to interpret
mode and wrapped so that every call's inputs and output are recorded
(``jax.debug.callback``, which also fires under ``jit``). The recorded
inputs go to the port's plain version, which must give:

* E and F: the reference's output exactly (they copy and double);
* G: within 1e-6 of max|reference| in every mode (a product and an add a
  step, each rounded to f32, in edge order on both sides);
* H: the reference's quantized cells and scales bit for bit, and its
  term within 1e-5 of max on the split re-sorted to (rb, st) order, the
  order the reference's kernel needs (ROADMAP queue 3 item 23).

The dense-term script runs once for the module (scale 0.01, ~17 s).
The scripts write a JAX compile cache under ``SGC_TPU_COMPILE_CACHE``,
pointed at a temporary directory; the two JAX settings they change are
restored afterwards and JAX's persistent-cache object is reset. Torch
is pinned to one intra-op thread, as in the other port test files.
"""

import contextlib
import io
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache
from jax.experimental import pallas as pl

from sgc_tpu_torch.ops import blockdense_int8 as h
from sgc_tpu_torch.ops import edge_accumulate as ea
from sgc_tpu_torch.ops import probe_copy as e_ops
from sgc_tpu_torch.ops import row_gather as rg

from test_torch_port_slice import reference_native_lpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
# the reference's gather and take probes at small sizes (form C of the
# take probe needs wcols == chunk)
GATHER_ARGV = ["--rows", "64", "--wcols", "64", "--f", "128", "--chunk",
               "32", "--chunks", "4", "--repeats", "1"]
TAKE_ARGV = ["--wcols", "64", "--f", "128", "--chunk", "64", "--chunks",
             "2", "--repeats", "1"]
DENSE_SCALE = "0.01"
# the settings the scripts change in JAX's global config
_JAX_SETTINGS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def t(a) -> torch.Tensor:
    """A CPU tensor of a recorded array (bf16 kept as bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def run_reference(script: str, argv: list, cache_dir) -> tuple[list, str]:
    """Run ``scripts/<script>`` as ``__main__`` with ``argv``; returns
    ``([(call, inputs, output), ...], stdout + stderr)``, ``call`` the
    interpreted Pallas callable of each call."""
    records = []
    orig = pl.pallas_call

    def recording_call(kernel, *a, **kw):
        kw["interpret"] = True
        fn = orig(kernel, *a, **kw)

        def call(*args):
            out = fn(*args)
            jax.debug.callback(
                lambda *v: records.append(
                    (fn, [np.asarray(x) for x in v[:-1]], np.asarray(v[-1]))),
                *args, out)
            return out

        return call

    saved = {k: getattr(jax.config, k) for k in _JAX_SETTINGS}
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording_call)
        mp.setenv("SGC_TPU_COMPILE_CACHE", str(cache_dir))
        mp.setenv("SGC_TPU_NO_CALIBRATE", "1")
        mp.setattr(sys, "argv", [script, *argv])
        try:
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(buf):
                runpy.run_path(os.path.join(SCRIPTS, script),
                               run_name="__main__")
            jax.effects_barrier()
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
            # the persistent cache object keeps the script's directory
            compilation_cache.reset_cache()
    return records, buf.getvalue()


# ------------------------------------------------------- the scripts' mains

# each port script's command line at small sizes on the CPU, and the
# lines it must print (the reference's fields)
_F = r"[0-9.]+"
MAIN_RUNS = {
    "exp_pallas_probe": ([], [
        rf"compiled kernel OK in {_F}s \(build {_F}s, launch {_F} ms\), "
        r"y\[0,1\]=2\.0"]),
    "exp_pallas_probe2": ([], [
        rf"per-CTA block index COMPILED in {_F}s, correct=True"]),
    "exp_take_probe": (TAKE_ARGV, [
        rf"{e} ok err=0\.0e\+00  {_F} ms -> {_F} ns/row \({_F}M rows/s\)"
        for e in rg.ENTRIES]),
    "exp_dma_gather_probe": ([], [r"DMA gather probe: COMPILED, correct = "
                                  r"True"]),
    "exp_gather_probe": (GATHER_ARGV, [
        rf"P1 compiled\+ran in {_F}s", r"P2 rel_err=\d\.\d\de[+-]\d\d",
        rf"P3 {_F} ms for 128 edges -> {_F} ns/edge \({_F}M edges/s\)"]),
}


@pytest.mark.parametrize("name", sorted(MAIN_RUNS))
def test_script_main_runs_on_the_cpu(name, capsys):
    """``python -m sgc_tpu_torch.scripts.<name> ... --device cpu``: exit
    code 0, the backend line where the reference prints one, and each of
    the reference's lines with its fields."""
    import importlib
    import re

    argv, patterns = MAIN_RUNS[name]
    mod = importlib.import_module(f"sgc_tpu_torch.scripts.{name}")
    assert mod.main([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    if name != "exp_dma_gather_probe":
        assert lines[0] == "backend: cpu"
    for pat in patterns:
        assert any(re.fullmatch(pat, ln) for ln in lines), (pat, lines)


def test_probe_kernels_build_apart_from_the_package_paths():
    """Every ``csrc/*.cu`` has an entry table and sits in exactly one
    build set: ``load_all`` (every package path) builds A-D's libraries
    and the attention kernels', and E-H's are built at the probes' first
    use."""
    from sgc_tpu_torch.ops import kernels

    sources = {p.stem for p in kernels.CSRC.glob("*.cu")}
    assert set(kernels._ENTRY) == sources
    assert set(kernels.KERNEL_SOURCES) | set(kernels.PROBE_SOURCES) == sources
    assert not set(kernels.KERNEL_SOURCES) & set(kernels.PROBE_SOURCES)
    assert set(kernels.PROBE_SOURCES) == {"probe_copy", "row_gather",
                                          "edge_accumulate",
                                          "blockdense_int8"}


# ----------------------------------------------------------------- kernel E

def test_scale2_matches_the_compile_probe(tmp_path, capsys):
    from sgc_tpu_torch.scripts import exp_pallas_probe

    records, text = run_reference("exp_pallas_probe.py", [], tmp_path)
    assert "compiled pallas OK" in text and len(records) == 1
    _, (x,), out = records[0]
    assert torch.equal(e_ops.scale2(t(x)), t(out))
    got = exp_pallas_probe.run("cpu")
    assert torch.equal(got["x"], t(x)) and torch.equal(got["y"], t(out))
    assert "y[0,1]=2.0" in capsys.readouterr().out


def test_select_blocks_matches_the_scalar_prefetch_probe(tmp_path):
    from sgc_tpu_torch.scripts import exp_pallas_probe2

    records, text = run_reference("exp_pallas_probe2.py", [], tmp_path)
    assert "correct=True" in text and len(records) == 1
    _, (sel, x), out = records[0]
    assert torch.equal(e_ops.select_blocks(t(x), t(sel), 8), t(out))
    # the port's script makes the reference's inputs
    px, psel = exp_pallas_probe2.make_inputs("cpu")
    assert torch.equal(px, t(x)) and torch.equal(psel, t(sel))
    assert exp_pallas_probe2.run(px, psel)["correct"]


def test_select_blocks_rejects_bad_shapes():
    x = torch.zeros((12, 4))
    with pytest.raises(ValueError, match="multiple of the block"):
        e_ops.select_blocks(x, torch.zeros(1, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="int32"):
        e_ops.select_blocks(x, torch.zeros(1, dtype=torch.int64), 4)


# ----------------------------------------------------------------- kernel F

@pytest.fixture(scope="module")
def take_reference(tmp_path_factory):
    return run_reference("exp_take_probe.py", TAKE_ARGV,
                         tmp_path_factory.mktemp("take"))


def test_row_gather_matches_every_take_form(take_reference, capsys):
    """The reference's three spellings (A take, B indexing, C
    take_along_axis) give one output, the port's ``x[idx]``; the port's
    probe prints one line per Hopper entry with the reference's fields
    (ROADMAP queue 3 item 24)."""
    from sgc_tpu_torch.scripts import exp_take_probe

    records, text = take_reference
    for form in "ABC":
        assert f"{form} ok err=0.0e+00" in text
    assert len(records) == 3 * 2        # 3 forms x (first + 1 repeat)
    outs = [out for _, _, out in records]
    _, (idx, x), _ = records[0]
    want = rg.row_gather_plain(t(x), t(idx))
    for _, (i, xx), out in records:
        assert np.array_equal(i, idx) and np.array_equal(xx, x)
        assert torch.equal(want, t(out))
    assert all(np.array_equal(o, outs[0]) for o in outs)
    px, pidx = exp_take_probe.make_inputs(64, 128, 64, 2)
    assert np.array_equal(px, x) and np.array_equal(pidx, idx)
    res = exp_take_probe.run(torch.from_numpy(px), torch.from_numpy(pidx), 1)
    lines = capsys.readouterr().out.splitlines()
    assert set(res) == set(rg.ENTRIES)
    for entry in rg.ENTRIES:
        assert res[entry]["err"] == 0.0
        assert any(ln.startswith(f"{entry} ok err=0.0e+00") and "ns/row" in ln
                   and "M rows/s" in ln for ln in lines)


def test_row_gather_matches_the_dma_probe_at_every_depth(tmp_path):
    """The async entry keeps ``in_flight`` rows in flight where the TPU
    probe waits on each copy (ROADMAP queue 3 item 24): every depth is
    the same function, equal to the reference's output."""
    from sgc_tpu_torch.scripts import exp_dma_gather_probe

    records, text = run_reference("exp_dma_gather_probe.py", [], tmp_path)
    assert "correct = True" in text and len(records) == 1
    _, (cols, x), out = records[0]
    for n in rg.IN_FLIGHT:
        assert torch.equal(rg.row_gather(t(x), t(cols), "async", n), t(out))
    assert torch.equal(rg.row_gather(t(x), t(cols), "load"), t(out))
    px, pcols = exp_dma_gather_probe.make_inputs()
    assert np.array_equal(px, x) and np.array_equal(pcols, cols)
    assert exp_dma_gather_probe.run(torch.from_numpy(px),
                                    torch.from_numpy(pcols))["correct"]


@pytest.mark.parametrize("bad", [{"entry": "take"}, {"in_flight": 3}])
def test_row_gather_rejects_unknown_entry_or_depth(bad):
    kw = {"entry": "async", "in_flight": 8, **bad}
    with pytest.raises(ValueError):
        rg.row_gather(torch.zeros((4, 4)), torch.zeros(2, dtype=torch.int32),
                      **kw)


# ----------------------------------------------------------------- kernel G

@pytest.mark.parametrize("mode", ea.MODES)
def test_edge_accumulate_matches_the_gather_probe(mode, tmp_path, capsys):
    from sgc_tpu_torch.scripts import exp_gather_probe

    records, text = run_reference("exp_gather_probe.py",
                                  GATHER_ARGV + ["--mode", mode], tmp_path)
    assert "P2 rel_err=" in text and len(records) == 2
    _, (rows, cols, vals, x), out = records[0]
    got = ea.edge_accumulate(t(rows), t(cols), t(vals), t(x), 64, mode)
    assert rel_err(got, out) <= 1e-6
    pr = exp_gather_probe.make_inputs(64, 64, 128, 32, 4)
    for a, b in zip(pr, (rows, cols, vals, x)):
        assert np.array_equal(a, b)
    res = exp_gather_probe.run(*(torch.from_numpy(a) for a in pr), 64, mode,
                               1)
    assert rel_err(res["out"], out) <= 1e-6
    ref_p2 = float(text.split("P2 rel_err=")[1].split()[0])
    assert res["rel_err_vs_oracle"] == pytest.approx(ref_p2, rel=0.05,
                                                     abs=1e-6)
    assert "ns/edge" in capsys.readouterr().out


def test_edge_accumulate_keeps_edge_order():
    """``rmw`` sums each row in edge order with f32 rounding at every
    step (1e8 + 1 - 1e8 is 0, not 1); ``store`` keeps each row's last
    edge."""
    rows = torch.tensor([0, 1, 0, 0, 1], dtype=torch.int32)
    cols = torch.tensor([0, 1, 1, 2, 2], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 1.0, 1.0, 3.0], dtype=torch.float32)
    x = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    rmw = ea.edge_accumulate(rows, cols, vals, x, 3, "rmw")
    assert rmw[:, 0].tolist() == [0.0, -3e8, 0.0]   # 2 - 3e8 rounds
    store = ea.edge_accumulate(rows, cols, vals, x, 3, "store")
    assert store[:, 0].tolist() == [-1e8, -3e8, 0.0]


# ----------------------------------------------------------------- kernel H

@pytest.fixture(scope="module")
def dense_reference(tmp_path_factory):
    """The reference's dense-term script at scale 0.01: its kernel-A
    feature-tile calls (ft 256, 512, 768) and its int8 calls (ft 256,
    768), one record each (the timed repeats are dropped)."""
    with reference_native_lpa():
        records, text = run_reference("exp_dense_term.py",
                                      ["--scale", DENSE_SCALE],
                                      tmp_path_factory.mktemp("dense"))
    # each timed call runs 1 + 3 times plus once for the row sums
    assert len(records) == 5 * 5, text
    a_calls = [records[i] for i in (0, 5, 10)]
    i8_calls = [records[i] for i in (15, 20)]
    return a_calls, i8_calls, text


@pytest.fixture(scope="module")
def port_dense(dense_reference):
    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.scripts import exp_dense_term

    plan = LocalityPlan.build(
        *synthetic_reddit_clustered(float(DENSE_SCALE), shuffle=True),
        formulation="blockdense_kernel", calibrate=True, device="cpu")
    x = torch.as_tensor(plan.features)
    return plan, x, exp_dense_term.run(plan.split_main, x, reps=1)


def resorted(call_inputs):
    """The int8 call's inputs with the cells sorted to (rb, st) order."""
    rb, st, sc, a8, xp = call_inputs
    o = np.lexsort((st, rb))
    return rb[o], st[o], sc[o], a8[o], xp


def int8_of(call_inputs) -> tuple[h.Int8Cells, torch.Tensor]:
    rb, st, sc, a8, xp = call_inputs
    c = h.int8_cells(t(a8), t(sc), rb, st, n_rb=int(rb.max()) + 1,
                     n_st=xp.shape[0] // a8.shape[2])
    return c, t(xp)


def test_quantization_is_the_reference_bit_for_bit(dense_reference):
    a_calls, i8_calls, _ = dense_reference
    cells = t(a_calls[0][1][3])            # the bf16 cells kernel A reads
    q, scales = h.quantize_cells(cells)
    for _, (rb, st, sc, a8, xp), _ in i8_calls:
        assert np.array_equal(q.numpy(), a8)
        assert np.array_equal(scales.numpy().view(np.int32), sc.view(np.int32))
    # and in chunks smaller than the cell count
    q2, s2 = h.quantize_cells(cells, chunk=5)
    assert torch.equal(q2, q) and torch.equal(s2, scales)


def test_int8_term_matches_the_reference_in_rb_st_order(dense_reference):
    """On the split re-sorted to (rb, st) order, the reference's own int8
    kernel's output equals the port's within 1e-5 of max, at both of its
    feature tiles."""
    _, i8_calls, _ = dense_reference
    for call, inputs, _ in i8_calls:
        sorted_in = resorted(inputs)
        want = np.asarray(call(*(jnp.asarray(v) for v in sorted_in)))
        c, xp = int8_of(sorted_in)
        assert rel_err(h.apply_cells_int8(c, xp), want) <= 1e-5
        # the port's answer does not depend on the cell order
        c_super, _ = int8_of(inputs)
        assert rel_err(h.apply_cells_int8(c_super, xp), want) <= 1e-5


def test_reference_int8_kernel_is_wrong_in_super_row_order(dense_reference):
    """ROADMAP queue 3 item 23: the reference's int8 kernel zeroes its
    output block whenever the row-block id changes between grid steps, so
    on the super-row split the script builds its output is far from the
    function (the script's own rowsum error reads 1.0), while on the same
    cells in (rb, st) order it agrees with the port."""
    _, i8_calls, text = dense_reference
    assert "rowsum_rel_err_vs_bf16 1.0e+00" in text
    call, inputs, out = i8_calls[-1]
    rb = inputs[0]
    assert np.any(np.diff(rb) < 0)          # super-row order: rb repeats
    c, xp = int8_of(inputs)
    port = h.apply_cells_int8(c, xp)
    assert rel_err(out, port) > 0.5
    sorted_in = resorted(inputs)
    again = np.asarray(call(*(jnp.asarray(v) for v in sorted_in)))
    assert rel_err(again, port) <= 1e-5


def test_feature_tile_sweep_is_one_function(dense_reference, port_dense):
    """The reference's kernel-A sweep (ft 256, 512, 768) computes one
    function, which the port's single kernel-A timing at "bf16" computes
    (ROADMAP queue 3 item 24)."""
    a_calls, _, _ = dense_reference
    plan, x, res = port_dense
    n_rows, F = plan.split_main.n_rows, x.shape[1]
    want = np.asarray(a_calls[0][2])[:n_rows, :F]
    for _, _, out in a_calls[1:]:
        assert rel_err(np.asarray(out)[:n_rows, :F], want) <= 1e-6
    assert rel_err(res["kernel_a_out"], want) <= 1e-5
    assert set(res["int8"]) == {256, 768}
    assert res["kernel_a_bf16_ms"] > 0


def test_dense_term_script_matches_the_reference(dense_reference, port_dense):
    """The port's plan gives the reference's cells (bit for bit) and its
    run prints the reference's int8 lines, whose row-sum errors are int8
    rounding alone (the reference's, re-sorted, agree)."""
    a_calls, i8_calls, _ = dense_reference
    plan, x, res = port_dense
    split = plan.split_main
    ref_cells = np.asarray(a_calls[0][1][3]).view(np.uint16)
    assert np.array_equal(split.cells, ref_cells)
    rb, st = i8_calls[0][1][0], i8_calls[0][1][1]
    assert np.array_equal(split.rb_ids, rb) and np.array_equal(split.st_ids,
                                                                st)
    for (call, inputs, _), ft in zip(i8_calls, (256, 768)):
        got = res["int8"][ft]
        assert torch.equal(got["xp"], t(inputs[4]))
        want = np.asarray(call(*(jnp.asarray(v) for v in resorted(inputs))))
        assert rel_err(got["out"], want) <= 1e-5
        assert 1e-3 < got["rowsum_rel_err_vs_bf16"] < 0.1


def test_dense_term_main_raises_without_a_cell(monkeypatch):
    """Where the calibrated split admits no cell (on the H100, ROADMAP
    queue 3 item 1; here rates under which no cell of the small graph
    pays), ``main`` raises rather than printing an empty run (ROADMAP
    queue 3 item 24)."""
    from sgc_tpu_torch.ops import calibrate
    from sgc_tpu_torch.scripts import exp_dense_term

    monkeypatch.setattr(calibrate, "measured_rates", lambda device=None: {
        "blockdense_eff_flops": 1e9, "xla_edges_per_s": 1.53e9,
        "probed": True})
    with pytest.raises(RuntimeError, match="queue 3 item 1"):
        exp_dense_term.main(["--scale", DENSE_SCALE, "--device", "cpu"])


def test_int8_cells_reject_bad_row_blocks():
    q = torch.zeros((2, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="rb_ids"):
        h.int8_cells(q, torch.ones(2), [0, 3], [0, 0], n_rb=2, n_st=1)
