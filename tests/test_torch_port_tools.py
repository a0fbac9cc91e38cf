"""The port's profiling helpers and tool CLIs, on the CPU:

* ``bench_timeit``'s line and ``Metrics``' ``report`` / ``spmm_rate``
  against the reference's;
* ``stack_sampler`` names a busy function; ``device_trace(None)`` records
  nothing and ``device_trace(dir)`` writes a Chrome trace;
* ``cli.devices`` exits 1 without a card unless asked for the CPU;
* ``cli.pallas_bench`` gives the keys of the reference's compiled-mode
  line plus ``device`` (and, with ``--blockdense``, kernels A + B
  against the plain version), its layout fields equal the reference's
  ``pallas_cost_model`` on the same layout, and ``--interpret`` raises.
"""

import io
import json
import re
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from sgc_tpu.cli.pallas_bench import pallas_cost_model as ref_cost_model
from sgc_tpu.data.synthetic import synthetic_reddit as ref_synthetic
from sgc_tpu.ops.spmm_pallas import tile_graph as ref_tile_graph
from sgc_tpu.utils import profiling as ref_prof

from sgc_tpu_torch.cli import devices, pallas_bench
from sgc_tpu_torch.utils import profiling as prof

LINE = re.compile(r"^(.{32}) min +\d+\.\d ms  med +\d+\.\d ms$")

# the reference's pallas_bench line in compiled mode (no --blockdense)
REFERENCE_KEYS = {
    "backend", "nodes", "edges", "features", "topology", "xla_segment_s",
    "xla_edges_per_s", "cost_model", "pallas_mode", "pallas_kernel",
    "pallas_s", "pallas_edges_per_s", "pallas_vs_xla", "rel_err_vs_xla"}
BLOCKDENSE_KEYS = {
    "blockdense_cells", "blockdense_dense_edges", "blockdense_cell_gb",
    "blockdense_s", "blockdense_edges_per_s", "blockdense_vs_xla",
    "blockdense_rel_err_vs_xla", "blockdense_pallas_s",
    "blockdense_pallas_vs_xla", "blockdense_pallas_rel_err"}
LAYOUT_KEYS = ("edges_padded", "padding_factor", "n_row_blocks",
               "n_stripes", "n_feature_tiles")


def test_bench_timeit_line_matches_reference():
    got, want = [], []
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(3) * len(calls)

    out = prof.bench_timeit("kernel b at F = 602", fn, reps=3,
                            emit=got.append)
    ref_prof.bench_timeit("kernel b at F = 602", lambda: np.ones(3), reps=3,
                          emit=want.append)
    assert len(calls) == 4                 # one warm call, then 3 timed
    assert torch.equal(out, torch.full((3,), 4.0))
    assert len(got) == len(want) == 1
    g, w = LINE.match(got[0]), LINE.match(want[0])
    assert g and w and g.group(1) == w.group(1)


def test_metrics_report_and_rate_match_reference():
    got, want = prof.Metrics(), ref_prof.Metrics()
    for m in (got, want):
        m.count("edges", 10)
        m.count("edges", 5.5)
        m.timings["precompute"] = 0.25
    assert got.report() == want.report()
    assert got.spmm_rate(1000, 2) == want.spmm_rate(1000, 2) == 8000.0
    assert got.spmm_rate(1000, 2, "train") == want.spmm_rate(1000, 2,
                                                             "train") == 0.0
    assert str(got) == str(want)
    with got.timer("precompute") as t:
        t.result = (torch.ones(2), {"x": torch.zeros(1)})
    assert got.timings["precompute"] > 0.25
    assert prof.effective_bandwidth_gbs(2e9, 0.5) == \
        ref_prof.effective_bandwidth_gbs(2e9, 0.5) == 4.0
    assert prof.effective_bandwidth_gbs(1.0, 0.0) == 0.0


def busy_spin(seconds):
    end = time.perf_counter() + seconds
    n = 0
    while time.perf_counter() < end:
        n += sum(range(200))
    return n


def test_stack_sampler_names_a_busy_function():
    with prof.stack_sampler(0.01) as sampler:
        busy_spin(0.5)
    top = sampler.report(3)
    assert len(sampler.samples) >= 10
    assert any("busy_spin" in t["where"] for t in top), top
    assert all(0 < t["frac"] <= 1 for t in top)
    assert not sampler._thread.is_alive()


def test_device_trace(tmp_path):
    with prof.device_trace(None) as p:
        assert p is None
    out = tmp_path / "trace"
    with prof.device_trace(str(out)) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in p.key_averages())


def test_devices_cli(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    assert devices.main([]) == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and "OK" not in out.out
    assert devices.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"torch {torch.__version__}")
    assert "matmul smoke test on cpu: OK (sum=2097152)" in out


def bench_line(*argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert pallas_bench.main(["--device", "cpu", "--json", *argv]) == 0
    return json.loads(buf.getvalue())


def test_pallas_bench_line_matches_reference_layout():
    line = bench_line("--scale", "0.005", "--repeats", "1")
    assert set(line) == REFERENCE_KEYS | {"device"}
    assert line["device"] == "cpu" and line["backend"] == "cpu"
    assert line["rel_err_vs_xla"] <= 1e-5
    graph, *_ = ref_synthetic(0.005)
    want = ref_cost_model(ref_tile_graph(graph, 2048, 2048, 1024), 602,
                          feature_tile=256, flat=False)
    for k in LAYOUT_KEYS:
        assert line["cost_model"][k] == want[k], k
    assert line["edges"] == graph.nnz
    cm = line["cost_model"]
    assert cm["bound_by"] in ("bytes", "operations") and cm["bound_ms"] > 0


def test_pallas_bench_blockdense_flat():
    line = bench_line("--scale", "0.005", "--repeats", "1", "--flat",
                      "--blockdense", "--precision", "bf16")
    assert set(line) == REFERENCE_KEYS | BLOCKDENSE_KEYS | {
        "device", "blockdense_pallas_vs_plain_rel_err"}
    # on the CPU both block-dense forms are the plain version
    assert line["blockdense_pallas_vs_plain_rel_err"] == 0.0
    assert line["topology"] == "clustered"
    assert line["cost_model"]["kernel"] == "flat"
    assert line["blockdense_pallas_rel_err"] <= 1e-2
    assert line["rel_err_vs_xla"] <= 1e-2
    assert {"ops", "bytes", "bound_ms"} <= set(
        line["cost_model"]["blockdense"])


def test_pallas_bench_interpret_raises():
    with pytest.raises(ValueError, match="interpreter"):
        pallas_bench.main(["--device", "cpu", "--scale", "0.005",
                           "--interpret"])
