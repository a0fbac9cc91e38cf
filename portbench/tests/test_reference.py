"""The frozen graph generator against the program's, and each plain
reference against the port's CPU path at a small scale."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import graphgen, spec
from portbench.reference import gat as ref_gat
from portbench.reference import sgc as ref_sgc

SHAPE = {"nodes": 232965, "edges": 11606919, "features": 602,
         "classes": 41, "train": 152410}
SCALE = 0.01


@pytest.fixture(scope="module")
def data():
    return graphgen.generate(SHAPE, {"kind": "clustered", "scale": SCALE},
                             2 ** 31 + 3)


def test_generator_is_the_programs(data):
    from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
    from sgc_tpu_torch.graph.sparse import SparseGraph

    g, x, y, idx = synthetic_reddit_clustered(SCALE, seed=2 ** 31 + 3,
                                              shuffle=True)
    mine = SparseGraph.from_scipy(graphgen.normalized(data))
    for k in ("rows", "cols", "vals", "row_ptr"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(g, k))
    np.testing.assert_array_equal(data.features, x)
    np.testing.assert_array_equal(data.labels, y)
    np.testing.assert_array_equal(data.idx_train, idx)


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -9,
                      1.0 + 3 * 2 ** -12])
    got = ref_sgc.tf32(t)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -3.0 - 2 ** -9, 1.0 + 2 ** -10])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_propagation_against_the_port(data):
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.ops.spmm import spmm

    g = SparseGraph.from_scipy(graphgen.normalized(data)).to("cpu")
    x = torch.as_tensor(data.features)
    got = spmm(g, spmm(g, x, impl="segment"), impl="segment")
    got = got[torch.as_tensor(data.idx_train)]
    want = ref_sgc.propagate(data.src, data.dst, data.n, data.features,
                             data.idx_train, 2, "cpu")
    assert spec.task("sgc").prop_gap(got, want) < 1e-6


def test_newton_head_against_the_port(data):
    from sgc_tpu_torch.train.optim import newton_linear_fit

    p = ref_sgc.propagate(data.src, data.dst, data.n, data.features,
                          data.idx_train, 2, "cpu")
    y = torch.as_tensor(data.labels[data.idx_train])
    w0, b0 = spec.task("sgc").init_head(7, 602, 41, torch.device("cpu"))
    w, b, loss = newton_linear_fit(w0, b0, p.float(), y, 0.0, steps=8)
    theta0 = torch.cat([w0, b0[None]]).double()
    theta, want_loss = ref_sgc.newton_head(p, y, theta0, 0.0, 8)
    gap = spec.task("sgc").head_gap(torch.cat([w, b[None]]), theta)
    assert gap < 1e-3
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-4)
    assert float(ref_sgc.head_loss(p, y, theta, 0.0)) == pytest.approx(
        float(want_loss), rel=1e-9)


def test_gat_pattern_is_the_operators(data):
    rows, cols = ref_gat.pattern(data.src, data.dst, data.n, "cpu")
    csr = graphgen.normalized(data).tocoo()
    order = np.lexsort((csr.col, csr.row))
    np.testing.assert_array_equal(rows.numpy(), csr.row[order])
    np.testing.assert_array_equal(cols.numpy(), csr.col[order])


def test_gat_steps_against_the_port(data):
    """Three Adam steps of the port's GAT (CPU path) against the
    reference's, by the numbers a run compares."""
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models.gat import GATLayer, multi_head_gat
    from sgc_tpu_torch.train.loops import node_cross_entropy, train_target

    torch.set_num_threads(2)
    task = spec.task("gat")
    cfg = spec.Benchmark().config("gat-reddit")
    g = SparseGraph.from_scipy(graphgen.normalized(data)).to("cpu")
    x = torch.as_tensor(data.features)
    target = train_target(g.n_rows, data.idx_train,
                          torch.as_tensor(data.labels[data.idx_train]))
    init = task.init_layers(9, cfg["layers"], torch.device("cpu"))
    layers = [GATLayer(*(t.clone() for t in init[i:i + 4])) for i in (0, 4)]
    params = [p for m in layers for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=cfg["optimizer"]["lr"])
    losses = []
    for k in range(3):
        opt.zero_grad(set_to_none=True)
        h = multi_head_gat(layers[0], x, g)
        logits = multi_head_gat(layers[1], h, g, concat=False,
                                activation=None)
        loss = node_cross_entropy(logits, *target)
        loss.backward()
        if k == 0:
            grad1 = [float(p.grad.norm()) for p in params]
            logits1 = logits.detach()[torch.as_tensor(data.idx_train)]
        opt.step()
        losses.append(float(loss))
    got = {"losses": losses, "grad1": grad1,
           "change": [float((p.detach() - t).norm())
                      for p, t in zip(params, init)], "logits": logits1}
    want = task.readings(ref_gat.train(
        init, data.src, data.dst, data.n, data.features, data.labels,
        data.idx_train, cfg["optimizer"], 3, "cpu"))
    out = task.gaps(got, want)
    assert out["loss_gap"] < 1e-5
    assert out["grad_gap"] < 1e-4
    assert out["change_gap"] < 1e-3
    assert out["logit_gap"] < 1e-5
