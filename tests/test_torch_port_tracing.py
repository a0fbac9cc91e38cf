"""The port's recorder of spans and counters (sgc_tpu_torch/utils/
profiling.py): off, a span does nothing and opens no profiler range;
under ``torch.profiler`` the Newton head, the hops and the GAT
Functions record their spans, nested and ordered, and the Chrome trace
carries them; counters keep their always-on and windowed totals apart.

The tests marked ``cuda`` need a CUDA device and skip without one. The
file imports neither JAX nor the reference package, so on a machine with
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_tracing.py
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sgc_tpu_torch.utils import profiling

HEAD_SPANS = ("head.factor", "head.step", "head.search")
GAT_SPANS = ("gat.spmm", "gat.scores", "gat.softmax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_trace():
    profiling.reset_trace()
    yield
    profiling.reset_trace()


def profiled(fn, device="cpu", trace_path=None):
    """``fn()`` under ``torch.profiler`` (CPU activity, and CUDA on a
    card), synchronized inside the window; the Chrome trace is written to
    ``trace_path`` when given."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return out


def fit_inputs(device, n=300, f=12, c=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, f, generator=g)
    y = torch.randint(0, c, (n,), generator=g)
    w0 = torch.zeros(f, c)
    b0 = torch.zeros(c)
    return [t.to(device) for t in (w0, b0, x, y)]


def newton_fit(device, steps=8):
    from sgc_tpu_torch.train.optim import newton_linear_fit

    w0, b0, x, y = fit_inputs(device)
    return newton_linear_fit(w0, b0, x, y, 1e-4, steps=steps)


def small_graph(device, n=400, e=3000, seed=21):
    import scipy.sparse as sp

    from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
    from sgc_tpu_torch.graph.sparse import SparseGraph

    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(e, np.float32),
                         (rng.integers(0, n, e), rng.integers(0, n, e))),
                        shape=(n, n))
    return SparseGraph.from_scipy(
        aug_normalized_adjacency(adj + adj.T)).to(device)


def gat_step(device, heads=(3, 2), f_in=10, hidden=6, classes=3):
    """One step of a two-layer GAT (``heads`` per layer): forward, loss,
    backward."""
    from sgc_tpu_torch.models import gat

    g = small_graph(device)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(g.n_rows, f_in, generator=gen).to(device)
    y = torch.randint(0, classes, (g.n_rows,), generator=gen).to(device)
    l1 = gat.init_multi_head(gen, heads[0], f_in, hidden, device=device)
    l2 = gat.init_multi_head(gen, heads[1], heads[0] * hidden, classes,
                             device=device)
    h = gat.multi_head_gat(l1, x, g)
    out = gat.multi_head_gat(l2, h, g, concat=False, activation=None)
    torch.nn.functional.cross_entropy(out, y).backward()
    return l1, l2


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ------------------------------------------------------------ tracing off

def test_span_off_is_one_shared_object():
    a, b = profiling.span("a", "cpu"), profiling.span("b")
    assert a is b
    with a:
        pass
    assert profiling.recorded_spans() == []


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    newton_fit("cpu")
    gat_step("cpu")
    assert profiling.recorded_spans() == []
    assert profiling.trace_summary() == {"spans": {}, "counts": {}}


# ------------------------------------------------------------- tracing on

def test_newton_fit_spans_nest_and_order():
    profiled(lambda: newton_fit("cpu"))
    spans = profiling.recorded_spans()
    named = by_name(spans)
    assert {k: len(v) for k, v in named.items()} == {
        "head.factor": 1, "head.step": 8, "head.search": 8}
    (factor,) = named["head.factor"]
    assert factor.parent is None
    steps, searches = named["head.step"], named["head.search"]
    assert all(s.parent is None for s in steps)
    for step, search in zip(steps, searches):
        assert search.parent is step
        assert step.t0 <= search.t0 <= search.t1 <= step.t1
    prev = factor.t1
    assert factor.t0 <= factor.t1
    for step in steps:
        assert prev <= step.t0
        prev = step.t1
    summary = profiling.trace_summary()["spans"]
    assert {k: summary[k]["count"] for k in HEAD_SPANS} == {
        "head.factor": 1, "head.step": 8, "head.search": 8}
    # on the CPU no event pair: no device time, host time only
    assert all(summary[k]["device_ms"] is None for k in HEAD_SPANS)
    assert all(summary[k]["host_ms"] > 0 for k in HEAD_SPANS)


@pytest.mark.parametrize("steps", [1, 3])
def test_newton_fit_spans_follow_the_steps(steps):
    profiled(lambda: newton_fit("cpu", steps))
    summary = profiling.trace_summary()["spans"]
    assert {k: v["count"] for k, v in summary.items()} == {
        "head.factor": 1, "head.step": steps, "head.search": steps}


def test_fit_is_the_same_with_tracing_on():
    w, b, loss = newton_fit("cpu")
    w2, b2, loss2 = profiled(lambda: newton_fit("cpu"))
    assert torch.equal(w, w2) and torch.equal(b, b2)
    assert torch.equal(loss, loss2)


def test_hops_record_one_span_each():
    from sgc_tpu_torch.graph.locality import LocalityPlan

    host = small_graph("cpu")
    g = host
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((g.n_rows, 8)).astype(np.float32)
    labels = rng.integers(0, 3, g.n_rows)
    idx = np.arange(0, g.n_rows, 4)
    plan = LocalityPlan.build(host, feats, labels, idx, ordering="none",
                              device="cpu")
    want = plan.propagate_train(3)
    got = profiled(lambda: plan.propagate_train(3))
    assert torch.equal(got, want)
    profiled(lambda: plan.propagate_all(2))
    spans = profiling.recorded_spans()
    assert [s.name for s in spans] == ["prop.hop"] * 5
    assert all(s.parent is None for s in spans)


def test_gat_step_records_each_function_per_head_and_layer(tmp_path):
    heads = (3, 2)
    path = tmp_path / "trace.json"
    profiled(lambda: gat_step("cpu", heads), trace_path=path)
    summary = profiling.trace_summary()["spans"]
    # forward and backward of each Function, once a head and layer
    assert {k: summary[k]["count"] for k in GAT_SPANS} == {
        k: 2 * sum(heads) for k in GAT_SPANS}
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    annotations = {e["name"] for e in events
                   if e.get("cat") == "user_annotation"}
    assert set(GAT_SPANS) <= annotations


def test_gat_grads_are_the_same_with_tracing_on():
    l1, l2 = gat_step("cpu")
    m1, m2 = profiled(lambda: gat_step("cpu"))
    for a, b in zip([*l1.parameters(), *l2.parameters()],
                    [*m1.parameters(), *m2.parameters()]):
        assert torch.equal(a.grad, b.grad)


def test_span_closes_on_an_exception():
    def boom():
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise ValueError("inside")

    with pytest.raises(ValueError):
        profiled(boom)
    named = by_name(profiling.recorded_spans())
    assert named["inner"][0].parent is named["outer"][0]
    profiled(lambda: profiling.span("after").__enter__().__exit__())
    assert by_name(profiling.recorded_spans())["after"][0].parent is None


# --------------------------------------------------------------- counters

def test_counters_keep_always_on_and_window_apart():
    name = "test.tracing.counter"
    before = profiling.read_counts([name])[name]
    profiling.count(name, 2)
    assert profiling.read_counts([name]) == {name: before + 2}
    assert name not in profiling.trace_summary()["counts"]
    profiled(lambda: profiling.count(name, 3))
    assert profiling.read_counts([name]) == {name: before + 5}
    assert profiling.trace_summary()["counts"][name] == 3
    profiling.reset_trace()
    assert profiling.trace_summary() == {"spans": {}, "counts": {}}
    assert profiling.read_counts({"label": name}) == {"label": before + 5}


def test_zero_counts_clears_the_always_on_totals_only():
    name = "test.tracing.zeroed"
    profiled(lambda: profiling.count(name, 4))
    profiling.zero_counts()
    assert profiling.read_counts([name]) == {name: 0}
    assert name not in profiling.read_counts()
    assert profiling.trace_summary()["counts"][name] == 4


def test_within_adds_a_sub_count_while_open():
    name, sub = "test.tracing.launch", "test.tracing.within"
    before = profiling.read_counts([name, sub])
    profiling.count(name)
    with profiling.within({name: sub}):
        profiling.count(name, 2)
        with profiling.within({name: sub + ".inner"}):
            profiling.count(name)
    profiling.count(name)
    got = profiling.read_counts([name, sub, sub + ".inner"])
    assert got[name] == before[name] + 5
    assert got[sub] == before[sub] + 3
    assert got[sub + ".inner"] == 1
    assert profiling._WITHIN == {}


def test_host_sync_counts_only_on_a_card():
    before = profiling.read_counts(["host_sync"])
    profiling.host_sync("cpu", 3)
    profiling.host_sync(torch.device("cpu"))
    profiling.sync("cpu")
    newton_fit("cpu")
    assert profiling.read_counts(["host_sync"]) == before


def test_cpu_wrappers_count_no_launch():
    from sgc_tpu_torch.ops.autograd import spmm_transposed
    from sgc_tpu_torch.ops.spmm import sddmm, spmm_segment

    g = small_graph("cpu")
    x = torch.randn(g.n_cols, 4)
    before = profiling.read_counts()
    spmm_segment(g, x)
    spmm_transposed(g, g.vals, torch.randn(g.n_rows, 4))
    sddmm(g, torch.randn(g.n_rows, 4), x)
    gat_step("cpu")
    assert profiling.read_counts() == before


# ------------------------------------------------------------ on the card

def host_blocks(events: list, inside: str) -> int:
    """The host's blocks on the device inside the user range ``inside``:
    each ``aten::_local_scalar_dense``, and each device or stream
    synchronize that is not part of one."""
    (win,) = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == inside and e.get("cat") == "user_annotation"]

    def within(e):
        return win[0] <= e["ts"] <= win[1]

    reads = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "aten::_local_scalar_dense" and within(e)]
    syncs = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("name") in ("cudaStreamSynchronize",
                                   "cudaDeviceSynchronize") and within(e)]
    free = [e for e in syncs
            if not any(s <= e["ts"] <= t for s, t in reads)]
    return len(reads) + len(free)


@pytest.mark.cuda
def test_cuda_host_sync_counts_the_profilers_host_blocks(cuda, tmp_path):
    from sgc_tpu_torch.models.sgc import SGC
    from sgc_tpu_torch.train.loops import train_linear

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4000, 64, generator=gen).to(cuda)
    y = torch.randint(0, 8, (4000,), generator=gen).to(cuda)
    model = SGC(torch.zeros(64, 8, device=cuda), torch.zeros(8, device=cuda))

    def fit():
        with record_function("fit"):
            train_linear(model, x, y, weight_decay=1e-4, trainer="newton",
                         newton_steps=8)

    fit()
    before = profiling.read_counts(["host_sync"])["host_sync"]
    path = tmp_path / "trace.json"
    profiled(fit, cuda, path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counted = profiling.trace_summary()["counts"]["host_sync"]
    assert counted == host_blocks(events, "fit")
    assert profiling.read_counts(["host_sync"])["host_sync"] == (
        before + counted)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(4, 2), (1, 3)])
def test_cuda_gat_step_launch_counts(cuda, heads):
    from sgc_tpu_torch.ops.edge_softmax import ENTRIES

    edge = tuple(f"launch.{e}" for e in ENTRIES)
    names = ("launch.csr_spmm", "within.csr_spmm_transposed",
             "launch.sddmm") + edge
    gat_step(cuda, heads)       # builds and caches the transpose
    torch.cuda.synchronize()
    before = profiling.read_counts(names)
    gat_step(cuda, heads)
    torch.cuda.synchronize()
    got = {k: n - before[k] for k, n in profiling.read_counts(names).items()}
    h = sum(heads)
    # kernel B forward and over the transpose; each attention entry once
    assert got == {"launch.csr_spmm": 2 * h,
                   "within.csr_spmm_transposed": h, "launch.sddmm": h,
                   **{k: h for k in edge}}
    profiled(lambda: gat_step(cuda, heads), cuda)
    window = profiling.trace_summary()["counts"]
    assert {k: window[k] for k in names} == got


@pytest.mark.cuda
def test_cuda_span_events_resolve(cuda):
    profiled(lambda: (newton_fit(cuda), gat_step(cuda)), cuda)
    spans = profiling.recorded_spans()
    assert {s.name for s in spans} == set(HEAD_SPANS) | set(GAT_SPANS)
    for s in spans:
        ms = s.device_ms()
        assert ms is not None and ms >= 0.0, (s.name, ms)
    summary = profiling.trace_summary()["spans"]
    assert all(v["device_ms"] >= 0.0 for v in summary.values())
