"""The ported onehot-geometry experiments and kernel A's cell order
(``sgc_tpu_torch/scripts/exp_{pad_study,crossover,flat_sweep,
hybrid_sweep,super_rows}.py``) against the reference's unchanged scripts.

The helpers and the conventions are ``test_torch_port_scripts.py``'s: each
reference script runs through ``runpy`` at a small size, its Pallas calls
in interpret mode (the CPU cannot compile them) and ``sync`` recording
what it synchronizes on, so that its outputs can be held against the
port's. Host results (tilings' padding, splits, dense fractions, cell
orders, stripe loads) must be the reference's bit for bit (the printed
rounding, or the arrays themselves); outputs, kernel C's plain version at
"f32" and "bf16" (one hop: only the f32 sum order differs), within 1e-5
of max.
"""

import ast
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from test_torch_port_scripts import (
    TOL,
    json_lines,
    recording_sync,
    rel_err,
    run_ref,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*a, **kw)


def synced_run(script, argv, cache, env=None):
    """``(json lines, text, the arrays the script synchronized on)``."""
    from sgc_tpu.utils import profiling

    synced = []
    text, code = run_ref(script, argv, cache, env=env, interpret=True,
                         patches=[(profiling, "sync",
                                   recording_sync(synced))])
    assert code == 0, text[-2000:]
    return json_lines(text), text, synced


# ------------------------------------------------------------ the pad study

PAD_SCALE = 0.01


def test_pad_study_matches_reference(tmp_path):
    """Every field of every (ordering, R, W) line is the reference's, the
    TPU projection under its TPU name included; kernel C's bound is the
    same at every tile; "BEST:" is the reference's pick."""
    from sgc_tpu_torch.data.synthetic import synthetic_reddit
    from sgc_tpu_torch.scripts import exp_pad_study as port

    text, code = run_ref("exp_pad_study.py", ["--scale", str(PAD_SCALE)],
                         tmp_path)
    assert code == 0
    ref = json_lines(text)
    graph, _, _, _ = synthetic_reddit(PAD_SCALE)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = port.run(graph)
    assert len(rows) == len(ref) == 36
    for got, want in zip(rows, ref):
        want = dict(want)
        want["tpu_v5e_proj_hop_s"] = want.pop("proj_hop_s")
        assert {k: got[k] for k in want} == want
        assert "proj_hop_s" not in got
    assert len({r["c_bound_ms"] for r in rows}) == 1
    best = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("BEST:")]
    ref_best = [ln for ln in text.splitlines() if ln.startswith("BEST:")]
    pick = ("order", "rb", "w", "pad", "nonempty")
    assert len(best) == len(ref_best) == 1
    g, w = json.loads(best[0][5:]), json.loads(ref_best[0][5:])
    assert {k: g[k] for k in pick} == {k: w[k] for k in pick}


# ------------------------------------------------------------ the crossover

CROSS_SCALE = 0.005


def test_crossover_matches_reference(tmp_path):
    """At one scale: the segment line's nodes and edges, ``pick_tiles``
    and the tiling's padding, each hybrid split's dense fraction and
    padding are the reference's; kernel C (f32 and bf16) and the hybrid
    hops agree with the reference's kernels within 1e-5 of max."""
    from sgc_tpu_torch.ops.spmm_hybrid import spmm_hybrid_split
    from sgc_tpu_torch.ops.spmm_tiled import spmm_tiled_flat
    from sgc_tpu_torch.scripts import exp_crossover as port

    ref, _, synced = synced_run(
        "exp_crossover.py", ["--scales", str(CROSS_SCALE), "--repeats", "1"],
        tmp_path)
    res = quiet(port.run_scale, CROSS_SCALE, "uniform", "cpu", 1)
    rows = res["rows"]
    assert [r["impl"] for r in rows] == [
        "segment", "tiled_flat_f32", "tiled_flat_bf16", "hybrid", "hybrid"]
    assert [r["impl"] for r in ref] == [
        "xla", "pallas_flat_f32", "pallas_flat_bf16", "hybrid", "hybrid"]
    assert (rows[0]["nodes"], rows[0]["edges"]) == (ref[0]["nodes"],
                                                    ref[0]["edges"])
    assert port.pick_tiles(rows[0]["nodes"]) == (ref[1]["rb"], ref[1]["w"])
    assert port.pick_tiles(80_001) == (2048, 2048)
    for got, want in zip(rows[1:], ref[1:]):
        keys = ("rb", "w", "pad") + (("dense_frac",) if want["impl"]
                                     == "hybrid" else ())
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert len(synced) == 5
    n, f = res["x"].shape
    seg_ref = synced[0][:n, :f]
    assert rel_err(res["ref"].numpy(), seg_ref) <= TOL
    tiled, targs = res["tiled"]
    for k, prec in enumerate(port.PRECISIONS):
        got = spmm_tiled_flat(tiled, res["x"], targs, prec).numpy()
        assert rel_err(got, synced[1 + k][:n, :f]) <= TOL, prec
    for k, (split, hargs) in enumerate(res["hybrid"].values()):
        got = spmm_hybrid_split(split, res["x"], hargs).numpy()
        assert rel_err(got, synced[3 + k][:n, :f]) <= TOL


# ------------------------------------------------------------ the flat sweep

FLAT_SCALE = 0.005


def test_flat_sweep_matches_reference(tmp_path):
    """Each tiling's padding is the reference's; kernel C agrees with the
    reference's kernel at every tiling at "f32" and at the reference's
    best tiling at "bf16"."""
    from sgc_tpu_torch.data.synthetic import synthetic_reddit
    from sgc_tpu_torch.ops.spmm_tiled import spmm_tiled_flat
    from sgc_tpu_torch.scripts import exp_flat_sweep as port

    ref, _, synced = synced_run(
        "exp_flat_sweep.py", ["--scale", str(FLAT_SCALE), "--repeats", "1"],
        tmp_path)
    graph, x, _, _ = synthetic_reddit(FLAT_SCALE)
    x = torch.as_tensor(x)
    layouts = []
    out = quiet(port.run, graph, x, 1,
                on_tiling=lambda t, a: layouts.append((t, a)))
    ref_rows = [r for r in ref if "pallas_s" in r and r["prec"] == "f32"]
    assert len(out["rows"]) == len(ref_rows) == 6
    for got, want in zip(out["rows"], ref_rows):
        for k in ("rb", "w", "c", "prec", "pad"):
            assert got[k] == want[k], k
    n, f = x.shape
    assert len(synced) == 8
    for k, (tiled, targs) in enumerate(layouts):
        got = spmm_tiled_flat(tiled, x, targs).numpy()
        assert rel_err(got, synced[1 + k][:n, :f]) <= TOL
    best = ref[-1]
    assert best["prec"] == "bf16"
    tiled, targs = next(
        (t, a) for t, a in layouts
        if (t.row_block, t.stripe) == (best["rb"], best["w"]))
    got = spmm_tiled_flat(tiled, x, targs, "bf16").numpy()
    assert rel_err(got, synced[7][:n, :f]) <= TOL


# ---------------------------------------------------------- the hybrid sweep

HYBRID_SCALE = "0.005"


def test_hybrid_sweep_matches_reference(tmp_path):
    """On the same LPA-ordered graph, each config's dense fraction,
    padding and ``min_fill`` are the reference's; the hop of each (R, W)
    split agrees with the reference's program at every feature tile."""
    from sgc_tpu_torch.ops.spmm_hybrid import spmm_hybrid_split
    from sgc_tpu_torch.scripts import exp_hybrid_sweep as port

    ref, text, synced = synced_run(
        "exp_hybrid_sweep.py", [], tmp_path,
        env={"SGC_BENCH_SCALE": HYBRID_SCALE})
    graph, feats = port.lpa_graph(float(HYBRID_SCALE))
    assert f"graph ready: {graph.nnz} edges, F=602" in text
    x = torch.as_tensor(feats)
    outs = {}
    rows = quiet(port.run, graph, x, 1, on_split=lambda s, a: outs.__setitem__(
        (s.tiled.row_block, s.tiled.stripe),
        spmm_hybrid_split(s, x, a).numpy()))
    ref_rows = [r for r in ref if "hop_s" in r]
    assert len(rows) == len(ref_rows) == 6
    for got, want in zip(rows, ref_rows):
        for k in ("rb", "w", "ft", "dense_frac", "pad", "min_fill"):
            assert got[k] == want[k], k
    assert len(synced) == 6 * 5        # a warm run and 4 timed, a config
    n, f = x.shape
    for k, (rb, w, ft) in enumerate(port.CONFIGS):
        assert rel_err(outs[(rb, w)], synced[5 * k][:n, :f]) <= TOL, (rb, w,
                                                                    ft)
# ------------------------------------------------------ kernel A's cell order

SUPER_SCALE = "0.01"


@pytest.fixture(scope="module")
def super_rows(tmp_path_factory):
    from sgc_tpu.graph import locality
    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.scripts import exp_super_rows as port

    plans = []
    real_build = locality.LocalityPlan.build.__func__

    def build(cls, *a, **kw):
        plans.append(real_build(cls, *a, **kw))
        return plans[-1]

    text, code = run_ref("exp_super_rows.py", [],
                         tmp_path_factory.mktemp("cache"),
                         env={"SGC_SUPER_SCALE": SUPER_SCALE},
                         patches=[(locality.LocalityPlan, "build",
                                   classmethod(build))],
                         interpret=True)
    assert code == 0
    data = synthetic_reddit_clustered(float(SUPER_SCALE), shuffle=True)
    plan = LocalityPlan.build(*data, formulation="blockdense",
                              calibrate=True, device="cpu")
    x = torch.as_tensor(plan.features)
    outs = {}
    with contextlib.redirect_stderr(io.StringIO()):
        got = port.run(plan, x, on_variant=lambda name, split, args:
                       outs.__setitem__(name, port.bd.apply_cells(
                           split, args, x, "f32")))
    return {"ref": json_lines(text)[-1], "ref_plan": plans[0],
            "plan": plan, "got": got, "outs": outs}


def test_super_rows_stripe_loads_match_reference(super_rows):
    ref, got = super_rows["ref"], super_rows["got"]
    assert list(got["rows"]) == list(ref["rows"])
    for name, want in ref["rows"].items():
        for k in ("stripe_loads", "n_cells", "n_slots", "cell_gb"):
            assert got["rows"][name][k] == want[k], (name, k)


@pytest.mark.parametrize("name", ["None", "S4", "S8", "S16", "S8G2",
                                  "S8G4"])
def test_super_rows_cell_order_matches_reference(super_rows, name):
    """Each variant's slots (rb, st), cells and remainder-free split are
    the reference's bit for bit on the same LPA-ordered graph."""
    from sgc_tpu.ops.spmm_blockdense import split_block_dense as ref_split
    from sgc_tpu_torch.scripts import exp_super_rows as port

    plan, ref_plan = super_rows["plan"], super_rows["ref_plan"]
    kw = dict(port.variants())[name]
    base = ref_plan.split_main
    want = ref_split(ref_plan.graph, 602, min_edges=base.min_edges, **kw)
    got = port.variant_split(plan, kw, 602)
    assert got.n_cells == want.n_cells and got.rest is None
    np.testing.assert_array_equal(got.rb_ids, np.asarray(want.rb_ids))
    np.testing.assert_array_equal(got.st_ids, np.asarray(want.st_ids))
    np.testing.assert_array_equal(
        got.cells, np.asarray(want.cells).view(np.uint16))


def test_super_rows_orders_agree_at_f32(super_rows):
    """Kernel A's term (its plain version here) is one function in every
    order: within 1e-5 of the (rb, st) order's at "f32"."""
    outs = super_rows["outs"]
    assert set(outs) == {"None", "S4", "S8", "S16", "S8G2", "S8G4"}
    for name, out in outs.items():
        assert rel_err(out.numpy(), outs["None"].numpy()) <= TOL, name


def test_super_rows_drops_the_alloc_prewarm():
    """The reference's ``prewarm_pool`` (``utils/alloc``, left out of the
    port) is not called, and the docstring says so."""
    from sgc_tpu_torch.scripts import exp_super_rows as port

    src = open(port.__file__).read()
    assert "prewarm_pool" in port.__doc__ and "utils.alloc" in port.__doc__
    tree = ast.parse(src)
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert "prewarm_pool" not in names


