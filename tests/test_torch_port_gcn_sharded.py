"""The sharded GCN (``parallel/gcn.py``) against the reference's.

One 4-rank gloo world (``parallel.bodies.gcn_checks``) runs
``fit_gcn_sharded`` on (4, 1) through the overlapped halo plan and the
all-gather, and ``make_sharded_gcn_step`` through the halo plan and the
block-dense plan (its backward on kernels A and B over the transposed
plans), all from the reference's initial parameters
(``init_gcn(PRNGKey(7))``); the reference runs on the virtual mesh.
Tolerances are the reference tests' own (tests/test_gcn_sharded.py):
losses rtol 1e-4 and atol 1e-5, W1 within 5e-3 of its scale, and the
block-dense step within rtol 2e-2 and atol 1e-3 of the segment step.

The gradient's scale: the reference's (4, 1) GCN step is held against
its (1, 1) step with weight decay. They agree, so the reference's GCN
step takes the true gradient (its partitioner derives the collectives),
unlike its SGC step (ROADMAP queue 3 item 17), and the port's agrees
with both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import NamedSharding, PartitionSpec as P

from sgc_tpu.graph.normalize import aug_normalized_adjacency
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.models.gcn import init_gcn
from sgc_tpu.parallel.blockdense import build_sharded_blockdense
from sgc_tpu.parallel.gcn import (
    fit_gcn_sharded as ref_fit_gcn,
    init_sharded_gcn,
    make_sharded_gcn_step,
)
from sgc_tpu.parallel.halo import build_halo
from sgc_tpu.parallel.mesh import NODES_AXIS, make_mesh as ref_mesh
from sgc_tpu.parallel.partition import pad_node_rows, partition_graph
from sgc_tpu.parallel.spmm import shard_features
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.parallel.bodies import (
    gcn_checks,
    write_inputs,
    write_plans,
)
from sgc_tpu_torch.parallel.distributed import launch

N, F, H = 96, 12, 16
FIT = dict(n_hidden=H, epochs=30, lr=0.01, weight_decay=5e-4)
STEPS = 10
BD = dict(n_features=F, row_block=16, stripe=16, min_edges=0)
TIMEOUT_S = 300.0


def _task(n=N, seed=0):
    """The reference test's clustered task."""
    rng = np.random.default_rng(seed)
    c = 3
    blocks = np.repeat(np.arange(c), n // c)
    r, co = np.triu_indices(n, 1)
    keep = rng.random(len(r)) < np.where(blocks[r] == blocks[co], 0.25,
                                         0.02)
    adj = sp.coo_matrix((np.ones(keep.sum(), np.float32),
                         (r[keep], co[keep])), shape=(n, n))
    a = aug_normalized_adjacency(adj + adj.T)
    x = rng.standard_normal((n, F)).astype(np.float32)
    x[np.arange(n), blocks] += 1.2
    idx_train = np.sort(rng.choice(n, n // 2, replace=False))
    return a, x, blocks.astype(np.int64), idx_train, c


@pytest.fixture(scope="module")
def case():
    a, x, y, idx, c = _task(seed=3)
    init = init_gcn(jax.random.PRNGKey(7), F, H, c)
    return {"a": a, "x": x, "y": y, "idx": idx, "c": c,
            "init": {k: np.asarray(getattr(init, k))
                     for k in ("w1", "b1", "w2", "b2")}}


@pytest.fixture(scope="module")
def port(case, tmp_path_factory):
    root = tmp_path_factory.mktemp("gcn")
    graph = PortGraph.from_scipy(case["a"])
    write_inputs(root, graph, case["x"], case["y"], case["idx"])
    bd = write_plans(root, graph, {4: True}, **BD)["plans"][4][2]
    assert bd.part_cells_int.sum() > 0 and bd.part_cells_bnd.sum() > 0
    out = launch(gcn_checks, 4, "gloo", tmp_path_factory.mktemp("init"),
                 (str(root), {"n_classes": case["c"], "init": case["init"],
                              "fit": {k: FIT[k] for k in (
                                  "n_hidden", "epochs", "lr",
                                  "weight_decay")},
                              "steps": STEPS, "precision": "bf16"}),
                 TIMEOUT_S)
    assert out[1:] == [None, None, None]
    return out[0]


def _ref_steps(case, mesh_shape, plan: str, steps: int):
    """The reference's step, ``steps`` times from the shared init."""
    mesh = ref_mesh(*mesh_shape)
    pg = partition_graph(RefGraph.from_scipy(case["a"]), mesh_shape[0])
    halo = build_halo(pg)
    kw = ({"halo": halo} if plan == "halo" else {
        "blockdense": build_sharded_blockdense(pg, halo, **BD)})
    xp = shard_features(mesh, pad_node_rows(jnp.asarray(case["x"]),
                                            pg.n_rows_padded))
    yy = np.zeros(pg.n_rows_padded, np.int32)
    yy[: N] = case["y"]
    mm = np.zeros(pg.n_rows_padded, np.float32)
    mm[case["idx"]] = 1.0
    spec = NamedSharding(mesh, P(NODES_AXIS))
    yy, mm = (jax.device_put(jnp.asarray(v), spec) for v in (yy, mm))
    state = init_sharded_gcn(mesh, jax.random.PRNGKey(7), F, H, case["c"],
                             lr=FIT["lr"], weight_decay=FIT["weight_decay"])
    step = make_sharded_gcn_step(mesh, pg, lr=FIT["lr"],
                                 weight_decay=FIT["weight_decay"], **kw)
    losses = []
    for _ in range(steps):
        state, loss = step(state, xp, yy, mm)
        losses.append(float(loss))
    return losses, {k: np.asarray(getattr(state.params, k))
                    for k in ("w1", "b1", "w2", "b2")}


def _close_w1(got, want):
    scale = max(np.abs(want).max(), 1e-8)
    assert np.abs(got - want).max() / scale < 5e-3


@pytest.mark.parametrize("exchange", ["halo", "allgather"])
def test_fit_gcn_sharded_matches_reference(port, case, exchange):
    params, losses = ref_fit_gcn(
        RefGraph.from_scipy(case["a"]), case["x"], case["y"], case["idx"],
        case["c"], mesh=ref_mesh(4, 1), seed=7,
        use_halo=exchange == "halo", **FIT)
    got = port[f"fit_{exchange}"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4, atol=1e-5)
    _close_w1(got["params"]["w1"], np.asarray(params.w1))
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("plan", ["halo", "blockdense"])
def test_sharded_gcn_step_matches_reference(port, case, plan):
    losses, params = _ref_steps(case, (4, 1), plan, STEPS)
    got = port[f"step_{plan}"]
    if plan == "halo":
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        _close_w1(got["params"]["w1"], params["w1"])
    else:
        # the bf16 cell term's backward rounds g where JAX rounds the
        # product: the reference's block-dense tolerance
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-2,
                                   atol=1e-3)
    assert got["losses"][-1] < got["losses"][0]


def test_sharded_gcn_step_differentiates_through_blockdense(port):
    """The reference's test: the block-dense step's losses match the
    segment step's to bf16 tolerance."""
    np.testing.assert_allclose(port["step_blockdense"]["losses"],
                               port["step_halo"]["losses"], rtol=2e-2,
                               atol=1e-3)


def test_reference_gcn_step_takes_the_true_gradient(port, case):
    """The reference's (4, 1) step equals its (1, 1) step with weight
    decay on: its GCN gradient is not scaled by the mesh."""
    l4, p4 = _ref_steps(case, (4, 1), "halo", 3)
    l1, p1 = _ref_steps(case, (1, 1), "halo", 3)
    np.testing.assert_allclose(l4, l1, rtol=1e-4, atol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p4[k], p1[k], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(port["step_halo"]["losses"][:3], l1,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("what", ["apply", "step", "fit"])
def test_sharded_gcn_needs_an_unsharded_feature_axis(port, what):
    assert "('nodes', 1) mesh" in port["errors"][what]
