"""GCNII on the port (``models/gcnii.py``, ``train/loops.py::train_gcnii``,
``cli/citation.py --model GCNII``) against the plain reference
(``tests/gcnii_reference.py``: the authors' two-term form in float64, its
own Adam), and the differentiable ``spmm(..., dense=)`` it runs on.

Weights are drawn with numpy from a seed and given to both. Tolerances,
relative to the reference's largest entry (the port runs in f32, the
reference in f64; 64 layers chain 64 sums and products, measured at
1.2e-7 to 6.1e-7 on these problems):

* logits, the first gradient of every leaf and the parameters after 3
  Adam steps: 2e-6;
* the loss: 1e-6 of the reference's;
* each leaf's change over the 3 steps: 2e-5 (a difference of two nearly
  equal f32 values, measured up to 4.7e-6).

A planted fault (one layer's ``alpha h0`` left out, or ``beta_l`` taken at
``l + 1``) must break one of them: the smallest, at 64 layers x 8,
reads 1.4e-5 on the logits and 7.8e-4 on a gradient.
"""

from __future__ import annotations

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from sgc_tpu_torch.cli import citation as port_citation
from sgc_tpu_torch.data.fixtures import write_planetoid
from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.models import gcnii as port_gcnii
from sgc_tpu_torch.models.registry import get_model
from sgc_tpu_torch.ops import autograd as port_ag
from sgc_tpu_torch.ops.spmm import spmm
from sgc_tpu_torch.train import loops as port_loops
from sgc_tpu_torch.utils import profiling
from sgc_tpu_torch.utils.config import CitationConfig
import gcnii_reference as ref

CPU = "cpu"
TOL = {"logits": 2e-6, "loss": 1e-6, "grad": 2e-6, "params": 2e-6,
       "change": 2e-5}
SETTING = dict(alpha=0.1, lamda=0.5, lr=0.01, wd_conv=0.01, wd_dense=5e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small problems (as the GCN tests:
    an oversubscribed pool runs many short ops tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape
    return float((got - want).abs().max() / want.abs().max())


def problem(seed=0, n=2000, e=8000, f=24, c=5, layers=8, hidden=16):
    """A random graph's raw draws and its port operator, features, labels,
    train rows and the five leaves drawn by the authors' rule."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    adj = sp.coo_matrix((np.ones(e, np.float32), (src, dst)), shape=(n, n))
    g = SparseGraph.from_scipy(aug_normalized_adjacency(adj + adj.T)).to(CPU)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    idx = np.sort(rng.choice(n, n // 2, replace=False))

    def u(shape, fan):
        return torch.tensor(rng.uniform(-fan ** -0.5, fan ** -0.5, shape),
                            dtype=torch.float32)

    init = {"w_in": u((f, hidden), f), "b_in": u((hidden,), f),
            "w_conv": u((layers, hidden, hidden), hidden),
            "w_out": u((hidden, c), hidden), "b_out": u((c,), hidden)}
    return dict(src=src, dst=dst, n=n, g=g, x=x, y=y, idx=idx, init=init)


def model_of(init):
    return port_gcnii.GCNII(*(init[k].clone() for k in ref.LEAVES))


def port_run(p, steps=3):
    """The port's first logits, loss and gradients, and its parameters
    after ``steps`` steps of ``train_gcnii`` at dropout 0."""
    model = model_of(p["init"])
    x = torch.from_numpy(p["x"])
    scaled = port_gcnii.scaled_operator(p["g"], SETTING["alpha"])
    logits = port_gcnii.gcnii_apply(model, x, scaled, SETTING["alpha"],
                                    SETTING["lamda"])
    target = port_loops.train_target(p["n"], p["idx"],
                                     torch.as_tensor(p["y"][p["idx"]]))
    loss = port_loops.node_cross_entropy(logits, *target)
    loss.backward()
    fit, _ = port_loops.train_gcnii(
        model_of(p["init"]), x, p["g"], p["idx"],
        torch.as_tensor(p["y"][p["idx"]]), epochs=steps, dropout=0.0,
        **SETTING)
    return {"logits1": logits.detach(), "loss": float(loss.detach()),
            "grad1": {k: getattr(model, k).grad for k in ref.LEAVES},
            "params": {k: getattr(fit, k) for k in ref.LEAVES}}


def ref_run(p, steps=3, **faults):
    return ref.train(p["init"], p["x"], p["src"], p["dst"], p["n"], p["idx"],
                     p["y"], steps=steps, **SETTING, **faults)


def errors(got, want, init) -> dict:
    """Each compared number's worst relative error."""
    return {
        "logits": rel(got["logits1"], want["logits1"]),
        "loss": abs(got["loss"] - want["losses"][0]) / want["losses"][0],
        "grad": max(rel(got["grad1"][k], want["grad1"][k])
                    for k in ref.LEAVES),
        "params": max(rel(got["params"][k], want["params"][k])
                      for k in ref.LEAVES),
        "change": max(rel(got["params"][k].double() - init[k].double(),
                          want["params"][k] - init[k].double())
                      for k in ref.LEAVES)}


SHAPES = {"8x16": dict(layers=8, hidden=16), "64x8": dict(layers=64,
                                                          hidden=8)}


@pytest.fixture(scope="module", params=list(SHAPES))
def compared(request):
    p = problem(**SHAPES[request.param])
    return p, port_run(p)


def test_gcnii_matches_reference(compared):
    p, got = compared
    errs = errors(got, ref_run(p), p["init"])
    assert all(errs[k] <= TOL[k] for k in TOL), errs


@pytest.mark.parametrize("fault", [{"drop_residual": 3}, {"beta_shift": 1}],
                         ids=["dropped-alpha-h0", "beta-shifted"])
def test_planted_fault_fails_the_comparison(compared, fault):
    p, got = compared
    errs = errors(got, ref_run(p, **fault), p["init"])
    assert any(errs[k] > TOL[k] for k in TOL), errs


def test_init_gcnii_shapes_and_bounds():
    gen = torch.Generator().manual_seed(3)
    m = port_gcnii.init_gcnii(gen, 30, 16, 5, 4, device=CPU)
    assert m.n_layers == 4
    shapes = {k: tuple(getattr(m, k).shape) for k in ref.LEAVES}
    assert shapes == {"w_in": (30, 16), "b_in": (16,),
                      "w_conv": (4, 16, 16), "w_out": (16, 5),
                      "b_out": (5,)}
    for k, fan in (("w_in", 30), ("b_in", 30), ("w_conv", 16),
                   ("w_out", 16), ("b_out", 16)):
        assert float(getattr(m, k).detach().abs().max()) <= fan ** -0.5
    again = port_gcnii.init_gcnii(torch.Generator().manual_seed(3), 30, 16,
                                  5, 4, device=CPU)
    assert all(torch.equal(getattr(m, k), getattr(again, k))
               for k in ref.LEAVES)
    assert [p.shape for p in m.conv_params()] == [(4, 16, 16)]
    assert len(m.dense_params()) == 4


def test_get_model_gcnii():
    assert get_model("GCNII") == (port_gcnii.init_gcnii,
                                  port_gcnii.gcnii_apply)


def small_graph(seed=4, n=300, e=1500):
    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(e, np.float32),
                         (rng.integers(0, n, e), rng.integers(0, n, e))),
                        shape=(n, n))
    return SparseGraph.from_scipy(aug_normalized_adjacency(adj + adj.T)).to(
        CPU)


def test_spmm_dense_matches_a_dense_product_under_autograd():
    g = small_graph()
    gen = torch.Generator().manual_seed(7)
    vals = torch.rand(g.n_edges_padded, generator=gen)
    vals[g.nnz:] = 0.0
    vals.requires_grad_()
    x = torch.randn(g.n_cols, 6, generator=gen, requires_grad=True)
    d = torch.randn(g.n_rows, 6, generator=gen, requires_grad=True)
    w = torch.randn(g.n_rows, 6, generator=gen)
    out = spmm(g.with_vals(vals), x, dense=d)
    (out * w).sum().backward()

    rows, cols = g.rows[:g.nnz].long(), g.cols[:g.nnz].long()
    v2 = vals.detach().clone().requires_grad_()
    x2, d2 = (t.detach().clone().requires_grad_() for t in (x, d))
    a = torch.zeros(g.n_rows, g.n_cols).index_put(
        (rows, cols), v2[:g.nnz], accumulate=True)
    want = a @ x2 + d2
    (want * w).sum().backward()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d.grad, d2.grad, rtol=0, atol=0)
    torch.testing.assert_close(vals.grad[:g.nnz], v2.grad[:g.nnz],
                               rtol=1e-5, atol=1e-6)
    assert float(vals.grad[g.nnz:].abs().max()) == 0.0


def test_spmm_dense_without_gradient_and_refusals():
    g = small_graph()
    x, d = torch.randn(g.n_cols, 4), torch.randn(g.n_rows, 4)
    for impl in ("auto", "segment"):
        torch.testing.assert_close(spmm(g, x, impl, dense=d),
                                   spmm(g, x) + d, rtol=1e-6, atol=1e-6)
    for impl in ("chunked", "tiled", "hybrid", "blockdense"):
        with pytest.raises(ValueError, match="dense"):
            spmm(g, x, impl, dense=d)


def test_scaled_operator_backward_reads_cached_values():
    g = small_graph(seed=9)
    gt, perm = port_ag.transposed(g)    # the pattern's values ask first
    s = port_gcnii.scaled_operator(g, 0.25)
    torch.testing.assert_close(s.vals, g.vals * 0.75)
    first = port_ag.on_transpose(s, s.vals)
    assert first is s.prepared_transpose
    assert port_ag.on_transpose(s, s.vals) is first
    want = torch.zeros_like(s.vals)
    want[:g.nnz] = s.vals[perm]
    assert torch.equal(first.vals, want)
    # the pattern's own values keep their cached transpose, and other
    # values are gathered afresh
    assert port_ag.on_transpose(g, g.vals) is gt
    other = g.vals * 0.75
    assert port_ag.on_transpose(g, other) is not first
    assert torch.equal(port_ag.on_transpose(g, other).vals, want)


def span_counts(fn) -> dict:
    profiling.reset_trace()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    counts = {k: v["count"] for k, v in
              profiling.trace_summary()["spans"].items()}
    profiling.reset_trace()
    return counts


def test_span_names_follow_the_caller():
    from sgc_tpu_torch.models import deep_gcn, gat, gcn

    g = small_graph()
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(g.n_rows, 10, generator=gen)

    def gcnii_step(layers=5):
        m = port_gcnii.init_gcnii(gen, 10, 8, 3, layers, device=CPU)
        s = port_gcnii.scaled_operator(g, 0.1)
        port_gcnii.gcnii_apply(m, x, s, 0.1, 0.5).sum().backward()

    def gat_step():
        layer = gat.init_multi_head(gen, 2, 10, 4, device=CPU)
        gat.multi_head_gat(layer, x, g).sum().backward()

    def gcn_step():
        gcn.gcn_apply(gcn.init_gcn(gen, 10, 8, 3, device=CPU), x,
                      g).sum().backward()
        deep_gcn.deep_gcn_apply(deep_gcn.init_deep_gcn(gen, 10, 8, 3, 4,
                                                       device=CPU),
                                x, g, remat=False).sum().backward()

    got = span_counts(gcnii_step)
    assert got == {"gcnii.prop": 2 * 5}
    got = span_counts(gat_step)
    assert got["gat.spmm"] == 2 * 2 and "gcnii.prop" not in got
    assert "gcn.spmm" not in got
    # GCN: 2 products; the deep stack: 4 layers, one product each
    assert span_counts(gcn_step) == {"gcn.spmm": 2 * (2 + 4)}


def test_train_gcnii_dropout_repeats_and_seed_draws():
    p = problem(n=1200, e=5000, layers=4, hidden=8)
    x, yt = torch.from_numpy(p["x"]), torch.as_tensor(p["y"][p["idx"]])
    runs = [port_loops.train_gcnii(model_of(p["init"]), x, p["g"], p["idx"],
                                   yt, epochs=3, dropout=0.6, seed=s)[0]
            for s in (5, 5, 6)]
    assert all(torch.equal(runs[0].w_conv, r.w_conv) for r in runs[:2])
    assert not torch.equal(runs[0].w_conv, runs[2].w_conv)
    plain = port_loops.train_gcnii(model_of(p["init"]), x, p["g"], p["idx"],
                                   yt, epochs=3, dropout=0.0)[0]
    assert not torch.equal(runs[0].w_conv, plain.w_conv)


@pytest.fixture(scope="module")
def planetoid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("planetoid_gcnii")
    write_planetoid(root, "cora", 900, 3000, 60, 4, 28, 200, seed=1)
    return root


def test_citation_gcnii_runs(planetoid_root):
    got = port_citation.run(
        CitationConfig(dataset="cora", model="GCNII", epochs=60, lr=0.01,
                       weight_decay=0.01, hidden=16, dropout=0.6),
        str(planetoid_root), device=CPU, gcnii={"layers": 8})
    assert got["precompute_time"] == 0.0 and got["train_time"] > 0
    assert got["test_accuracy"] > 0.5      # 4 classes: 2x chance
    again = port_citation.run(
        CitationConfig(dataset="cora", model="GCNII", epochs=60, lr=0.01,
                       weight_decay=0.01, hidden=16, dropout=0.6),
        str(planetoid_root), device=CPU, gcnii={"layers": 8})
    assert again["test_accuracy"] == got["test_accuracy"]
    with pytest.raises(ValueError, match="GCNII"):
        port_citation.run(CitationConfig(dataset="cora", model="GCNII",
                                          tuned=True),
                          str(planetoid_root), device=CPU)


def test_citation_main_gcnii_takes_the_authors_defaults(planetoid_root,
                                                        monkeypatch):
    seen = {}

    def run(cfg, data_path, **kw):
        seen.update(cfg=cfg, **kw)
        return {"val_accuracy": 0.5, "test_accuracy": 0.5,
                "precompute_time": 0.0, "train_time": 1.0,
                "total_time": 1.0}

    monkeypatch.setattr(port_citation, "run", run)
    monkeypatch.setattr(sys, "argv", [
        "citation", "--model", "GCNII", "--data_path", str(planetoid_root),
        "--device", "cpu"])
    with redirect_stdout(io.StringIO()):
        port_citation.main()
    cfg = seen["cfg"]
    assert (cfg.model, cfg.lr, cfg.weight_decay, cfg.hidden, cfg.dropout) \
        == ("GCNII", 0.01, 0.01, 64, 0.6)
    assert seen["gcnii"] == {"layers": 64, "alpha": 0.1, "lamda": 0.5,
                             "wd_dense": 5e-4}
    monkeypatch.setattr(sys, "argv", [
        "citation", "--data_path", str(planetoid_root), "--device", "cpu"])
    with redirect_stdout(io.StringIO()):
        port_citation.main()
    cfg = seen["cfg"]
    assert (cfg.model, cfg.lr, cfg.weight_decay, cfg.hidden, cfg.dropout) \
        == ("SGC", 0.2, 5e-6, 0, 0.0)


def test_citation_main_gcnii_runs(planetoid_root, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "citation", "--model", "GCNII", "--layers", "4", "--hidden", "8",
        "--epochs", "5", "--data_path", str(planetoid_root), "--device",
        "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        port_citation.main()
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("Validation Accuracy: ")
    assert lines[1].startswith("Pre-compute time: 0.0000s")
