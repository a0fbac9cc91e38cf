"""The sharded path on ``torch.distributed`` against the reference.

The port's ranks are spawned (``parallel.distributed.launch``: the
``spawn`` start method, gloo, a ``file://`` store under pytest's tmp
dir) on the CPU and run ``parallel.bodies.sharded_checks`` once for the
whole module; the reference runs on the virtual 8-device CPU mesh that
``tests/conftest.py`` sets up. Inputs come from one seed with numpy.

* every ``spmm_sharded`` branch (all-gather, halo, overlapped halo, each
  with and without ``edge_chunk``, block-dense at both precisions) on
  meshes (4, 1) and (2, 2), two hops, against the reference's
  ``propagate_sharded``: rtol 1e-5, atol 1e-6 (the two packages differ
  only in f32 summation order; the block-dense cells are bf16 in both);
* ``col_chunk``: the same bits as the unpaneled hops, the consume form,
  and the reference's rejections with its messages;
* the overlapped hops start the exchange, run the interior kernel
  launches, then wait, then the boundary ones;
* ``validate_exchange`` clean and with a fault, ``assert_deterministic``,
  ``put_global`` / ``fetch_global`` round trips;
* ``make_sharded_train_step``, 3 steps from the reference's initial
  state: losses rtol 1e-4; W rtol 1e-3, atol 1e-5 (the reference's own
  tolerances, tests/test_parallel.py), against the reference's (1, 1)
  step, and against its (2, 2) step without weight decay (its (2, 2)
  gradient is scaled, ROADMAP queue 3);
* the launcher kills the ranks and raises on a failure and at its
  deadline.

Every spawn has its own deadline (the launcher's ``timeout_s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import NamedSharding, PartitionSpec as P

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.parallel import make_mesh as ref_mesh
from sgc_tpu.parallel import partition_graph as ref_partition
from sgc_tpu.parallel.blockdense import build_sharded_blockdense
from sgc_tpu.parallel.halo import build_halo
from sgc_tpu.parallel.mesh import NODES_AXIS
from sgc_tpu.parallel.partition import pad_node_rows
from sgc_tpu.parallel.spmm import propagate_sharded, shard_features
from sgc_tpu.parallel.train import init_sharded_state, make_sharded_train_step
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.parallel.bodies import (
    sharded_checks,
    write_inputs,
    write_plans,
)
from sgc_tpu_torch.parallel.distributed import launch
from sgc_tpu_torch.parallel.train import state_arrays

N, F, C = 150, 24, 4
DEGREE = 2
EDGE_CHUNK = 128
COL_CHUNKS = (16, 13)
FAULT = (1, 2)
BD = dict(n_features=F, row_block=32, stripe=32, min_edges=30.0)
SHORT_BD = dict(n_features=F, row_block=8, stripe=8, min_edges=3.0)
LR = 0.2
TIMEOUT_S = 300.0
FORMS = ("allgather", "allgather_ec", "halo", "halo_ec", "overlap",
         "overlap_ec", "blockdense", "blockdense_bf16")
MESHES = ((4, 1), (2, 2))
# (name, mesh, n_parts, halo, weight decay, reference run to compare):
# the reference's (1, 1) step for the port's true gradient on any mesh;
# its (2, 2) step where no weight decay shows its scaled gradient
TRAIN = (("2x2", (2, 2), 2, "none", 1e-5, "1x1"),
         ("2x2_wd0", (2, 2), 2, "none", 0.0, "2x2_wd0"),
         ("1x1", (1, 1), 1, "none", 1e-5, "1x1"),
         ("4x1_overlap", (4, 1), 4, "overlap", 1e-5, "1x1"),
         ("2x2_wd3", (2, 2), 2, "none", 3.0, "1x1_wd3"))


def _data():
    """A clustered graph (dense diagonal communities, sparse crossings:
    interior and boundary cells and remainders) as SGC's operator, D^-1/2
    A D^-1/2 of the symmetrized pattern with self loops, features and
    labels."""
    rng = np.random.default_rng(7)
    sizes = (38, 37, 38, 37)
    blocks = [sp.random(s, s, density=0.45, dtype=np.float32,
                        random_state=int(rng.integers(1 << 30)))
              for s in sizes]
    cross = sp.random(N, N, density=0.03, dtype=np.float32,
                      random_state=int(rng.integers(1 << 30)))
    a = sp.block_diag(blocks) + cross
    a = ((a + a.T + sp.eye(N)) > 0).astype(np.float32)
    d = np.asarray(a.sum(axis=1)).ravel() ** -0.5
    a = (sp.diags(d) @ a @ sp.diags(d)).astype(np.float32).tocsr()
    x = rng.standard_normal((N, F)).astype(np.float32)
    labels = rng.integers(0, C, N)
    return a, x, labels


def _short_data():
    """22 nodes: at P = 4 (8 rows a part) the third part has 6 rows and
    the fourth none."""
    rng = np.random.default_rng(11)
    a = sp.random(22, 22, density=0.3, dtype=np.float32, random_state=11)
    a = ((a + a.T + sp.eye(22)) > 0).astype(np.float32)
    d = np.asarray(a.sum(axis=1)).ravel() ** -0.5
    a = (sp.diags(d) @ a @ sp.diags(d)).astype(np.float32).tocsr()
    return a, rng.standard_normal((22, F)).astype(np.float32)


def _ref_train_state(weight_decay, mesh=None):
    return init_sharded_state(mesh or ref_mesh(1, 1), jax.random.PRNGKey(0),
                              F, C, LR, weight_decay)


@pytest.fixture(scope="module")
def case():
    a, x, labels = _data()
    return {"a": a, "x": x, "labels": labels, "ref_graph":
            RefGraph.from_scipy(a)}


@pytest.fixture(scope="module")
def port(case, tmp_path_factory):
    """The port's results: one 4-rank spawn for every case."""
    plan_dir = tmp_path_factory.mktemp("plans")
    graph = PortGraph.from_scipy(case["a"])
    write_inputs(plan_dir, graph, case["x"], case["labels"], np.arange(N))
    built = write_plans(plan_dir, graph, {4: True, 2: True, 1: False}, **BD)
    bd4 = built["plans"][4][2]
    # the case exercises interior and boundary cells and remainders
    assert bd4.part_cells_int.sum() > 0 and bd4.part_cells_bnd.sum() > 0
    assert bd4.sparse_edges > 0
    short_dir = tmp_path_factory.mktemp("short")
    a, x = _short_data()
    graph = PortGraph.from_scipy(a)
    write_inputs(short_dir, graph, x, np.zeros(22, np.int64), np.arange(22))
    pg = write_plans(short_dir, graph, {4: True}, **SHORT_BD)["plans"][4][0]
    assert int(np.count_nonzero(pg.vals[3])) == 0      # an empty part
    cfg = {"degree": DEGREE, "edge_chunk": EDGE_CHUNK,
           "col_chunks": list(COL_CHUNKS), "fault": list(FAULT),
           "short_dir": str(short_dir),
           "train": [{"name": name, "mesh": list(mesh), "n_parts": parts,
                      "halo": halo, "steps": 3, "lr": LR,
                      "weight_decay": wd,
                      "state": state_arrays(_ref_train_state(wd))}
                     for name, mesh, parts, halo, wd, _ in TRAIN]}
    out = launch(sharded_checks, 4, "gloo",
                 tmp_path_factory.mktemp("init"), args=(str(plan_dir), cfg),
                 timeout_s=TIMEOUT_S)
    assert out[1:] == [None, None, None]
    return out[0]


def _ref_forms(graph, x, mesh_shape, bd_kw):
    n_parts, n_feat = mesh_shape
    mesh = ref_mesh(n_parts, n_feat)
    pg = ref_partition(graph, n_parts)
    ho = build_halo(pg, overlap=True)
    h = build_halo(pg)
    bd = build_sharded_blockdense(pg, h, **bd_kw)
    xs = shard_features(mesh, pad_node_rows(jnp.asarray(x),
                                            pg.n_rows_padded))
    forms = {"allgather": {}, "allgather_ec": {"edge_chunk": EDGE_CHUNK},
             "halo": {"halo": h}, "halo_ec": {"halo": h,
                                              "edge_chunk": EDGE_CHUNK},
             "overlap": {"halo": ho}, "overlap_ec": {
                 "halo": ho, "edge_chunk": EDGE_CHUNK},
             "blockdense": {"blockdense": bd, "precision": "f32"},
             "blockdense_bf16": {"blockdense": bd, "precision": "bf16"}}
    return {name: np.asarray(jax.jit(lambda v, kw=kw: propagate_sharded(
        mesh, pg, v, DEGREE, **kw))(xs)) for name, kw in forms.items()}


@pytest.fixture(scope="module")
def ref(case):
    out = {f"{s[0]}x{s[1]}": _ref_forms(case["ref_graph"], case["x"], s, BD)
           for s in MESHES}
    a, x = _short_data()
    out["short/4x1"] = _ref_forms(RefGraph.from_scipy(a), x, (4, 1),
                                  SHORT_BD)
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mesh_name,n", [("4x1", N), ("2x2", N),
                                         ("short/4x1", 22)])
def test_sharded_form_matches_reference(port, ref, mesh_name, n, form):
    got = port["forms"][f"{mesh_name}/{form}"]
    want = ref[mesh_name][form]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[n:].any()      # padded rows stay exactly zero


def test_sharded_forms_match_scipy(port, case):
    a, x = case["a"], case["x"]
    want = a @ (a @ x)
    for key, got in port["forms"].items():
        if key.startswith("short/"):
            continue
        # the block-dense cells hold bf16 values (~2^-8 relative)
        tol = 3e-2 if "blockdense" in key else 1e-5
        np.testing.assert_allclose(got[:N], want, rtol=tol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("key", [
    f"{h}/ec={e}/cc={c}" for h in ("allgather", "halo", "overlap")
    for e in (None, EDGE_CHUNK) for c in COL_CHUNKS] + ["consume"])
def test_col_chunk_same_bits(port, key):
    assert port["col_chunk_same_bits"][key] is True


@pytest.mark.parametrize("key,match", [
    ("consume_two", "one-element"),
    ("col_chunk_feat", "feat"),
    ("col_chunk_blockdense", "col_chunk applies to the segment"),
    ("edge_chunk_blockdense", "edge_chunk applies to the segment"),
    ("parts", "graph has 2 parts, mesh nodes axis is 4"),
    ("form", "unknown form 'einsum'"),
    ("nccl_on_cpu", "transport 'nccl' needs CUDA devices"),
    ("transport", "unknown transport 'mpi'"),
])
def test_rejections_keep_the_references_messages(port, key, match):
    assert match in port["errors"][key]


def test_overlapped_hops_run_interior_before_the_wait(port):
    """The exchange starts, the interior launches read x_local (R rows),
    then the wait, then the boundary launches read the halo (P * H
    rows): the port's counterpart of tests/test_overlap_structure.py."""
    ev = port["order"]
    cut = ev.index("|")
    halo_hop, bd_hop = ev[:cut], ev[cut + 1:]
    R = halo_hop[1][1]
    ph = halo_hop[3][1]
    assert halo_hop == ["exchange", ("B", R), "wait", ("B", ph)]
    assert bd_hop == ["exchange", ("A", R), ("B", R), "wait", ("A", ph),
                      ("B", ph)]


def test_validate_exchange_clean_and_faulted(port):
    deltas = port["deltas"]
    assert deltas.shape == (4, 4) and not deltas.any()
    src, dst = FAULT
    msg = port["errors"]["fault"]
    assert "halo exchange corruption" in msg
    assert f"src part {src} -> dst part {dst}" in msg
    assert "(1 corrupted pairs total)" in msg


def test_assert_deterministic_catches_a_changing_result(port):
    assert port["errors"]["deterministic"].startswith(
        "non-deterministic result on run 1")


@pytest.mark.parametrize("spec", [
    "('nodes', 'feat')", "('nodes', None)", "('nodes',)",
    "('feat', None)", "(None, 'feat')", "()"])
def test_put_fetch_round_trip(port, spec):
    assert port["round_trips"][spec] is True


def _ref_train(case, mesh_shape, weight_decay, halo):
    mesh = ref_mesh(*mesh_shape)
    pg = ref_partition(case["ref_graph"], mesh_shape[0])
    xs = shard_features(mesh, pad_node_rows(jnp.asarray(case["x"]),
                                            pg.n_rows_padded))
    spec = NamedSharding(mesh, P(NODES_AXIS))
    labels = jax.device_put(pad_node_rows(
        jnp.asarray(case["labels"], jnp.int32), pg.n_rows_padded), spec)
    mask = jax.device_put(pad_node_rows(jnp.ones(N, jnp.float32),
                                        pg.n_rows_padded), spec)
    state = _ref_train_state(weight_decay, mesh)
    step = make_sharded_train_step(
        mesh, pg, degree=DEGREE, lr=LR, weight_decay=weight_decay,
        halo=build_halo(pg, overlap=True) if halo else None)
    losses = []
    for _ in range(3):
        state, loss = step(state, xs, labels, mask)
        losses.append(float(loss))
    return losses, np.asarray(state.params.w)


@pytest.fixture(scope="module")
def ref_train(case):
    return {"2x2_wd0": _ref_train(case, (2, 2), 0.0, False),
            "1x1": _ref_train(case, (1, 1), 1e-5, False),
            "1x1_wd3": _ref_train(case, (1, 1), 3.0, False),
            "2x2_wd3": _ref_train(case, (2, 2), 3.0, False)}


@pytest.mark.parametrize("name,ref_name", [(t[0], t[5]) for t in TRAIN])
def test_sharded_train_step_matches_reference(port, ref_train, name,
                                              ref_name):
    got = port["train"][name]
    want_losses, want_w = ref_train[ref_name]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4)
    np.testing.assert_allclose(got["w"], want_w, rtol=1e-3, atol=1e-5)


def test_reference_train_step_scales_its_gradient(ref_train):
    """The deviation the port's true gradient pins: the reference's
    (2, 2) step sums dW over both axes' replicas (ROADMAP queue 3), which
    weight decay 3.0 makes visible; the port's (2, 2) step matches the
    reference's (1, 1) step instead (the test above)."""
    _, w22 = ref_train["2x2_wd3"]
    _, w11 = ref_train["1x1_wd3"]
    assert np.abs(w22 - w11).max() > 1e-2


def test_launch_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        launch(sharded_checks, 2, "gloo", tmp_path,
               args=(str(tmp_path / "absent"), {}), timeout_s=120.0)


def test_launch_kills_the_ranks_at_its_deadline(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish"):
        launch(sharded_checks, 2, "gloo", tmp_path,
               args=(str(tmp_path / "absent"), {}), timeout_s=0.2)


def test_local_mesh_and_device_rules(monkeypatch):
    """Without a process group only a (1, 1) mesh exists, its collectives
    are the identity and it names no transport; without a card the
    default device raises instead of falling back to the CPU."""
    import torch

    from sgc_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.transport is None and mesh.size == 1
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.all_to_all("nodes", x), x)
    assert torch.equal(mesh.all_gather("feat", x, dim=1), x)
    assert torch.equal(mesh.all_reduce("nodes", x), x)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="initialized process group"):
        make_mesh(1, 1, device="cpu", transport="gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, 1)



@pytest.fixture(scope="module")
def smoke(case, tmp_path_factory):
    """The chip smoke's rank bodies on the CPU at the module's size: a
    4-rank gloo world (``smoke_world``) and a world of one rank
    (``smoke_world_of_one``, two gloo meshes in place of NCCL and
    gloo)."""
    import torch

    from sgc_tpu_torch.ops.spmm import spmm_segment
    from sgc_tpu_torch.parallel.bodies import (
        blockdense_operator_vals,
        smoke_world,
        smoke_world_of_one,
    )

    root = tmp_path_factory.mktemp("smoke")
    graph = PortGraph.from_scipy(case["a"])
    write_inputs(root, graph, case["x"], case["labels"], np.arange(N))
    pg, ho, bd = write_plans(root, graph, {4: True, 2: False, 1: False},
                             **BD)["plans"][4]
    x = torch.from_numpy(case["x"])
    for name, g in (("segment", graph), ("blockdense", graph.with_vals(
            blockdense_operator_vals(graph, pg, ho, bd)))):
        g = g.to("cpu")
        np.save(root / f"ref_{name}.npy",
                spmm_segment(g, spmm_segment(g, x)).numpy())
    (root / "ready").touch()
    state = state_arrays(_ref_train_state(1e-5))
    forms = [
        ("allgather", (4, 1), "allgather", {}, "segment", True),
        ("halo", (4, 1), "halo", {}, "segment", True),
        ("overlap", (4, 1), "overlap", {}, "segment", False),
        ("blockdense_f32", (4, 1), "blockdense", {"precision": "f32"},
         "blockdense", True),
        ("edge_chunk", (4, 1), "overlap", {"edge_chunk": EDGE_CHUNK},
         "segment", False),
        ("col_chunk", (4, 1), "halo", {"col_chunk": COL_CHUNKS[0]},
         "segment", False),
        ("halo_2x2", (2, 2), "halo", {}, "segment", False)]
    cfg = {"degree": DEGREE, "tolerance": 1e-5, "state": state, "steps": 3,
           "lr": LR, "weight_decay": 1e-5, "scaling_repeats": 1, "reps": 2,
           "device": "cpu", "transports": ("gloo", "gloo"),
           "forms": [{"name": n, "mesh": list(m), "plan": p, "kw": kw,
                      "ref": f"ref_{ref}.npy", "ref_tolerance": 1e-5,
                      "timed": timed, "keep": n == "halo",
                      "same_bits_as": "halo" if n == "col_chunk" else None}
                     for n, m, p, kw, ref, timed in forms]}
    ranks = launch(smoke_world, 4, "gloo", root / "init", (str(root), cfg),
                   TIMEOUT_S)
    one = launch(smoke_world_of_one, 1, "gloo", root / "init1",
                 (str(root), cfg), TIMEOUT_S)[0]
    return {"ranks": ranks, "one": one, "forms": [f[0] for f in forms]}


def test_smoke_bodies_run_on_the_cpu(smoke):
    ranks, one = smoke["ranks"], smoke["one"]
    for r in ranks:
        assert list(r["forms"]) == smoke["forms"]
        for name, rec in r["forms"].items():
            assert rec["held_launches"] > 0, name
            assert (rec["hops_s"] is None) == (name not in (
                "allgather", "halo", "blockdense_f32")), name
            for _, rel in rec["vs_plain"].values():
                assert rel == 0.0   # the plain versions hold themselves
        assert r["forms"]["col_chunk"]["same_bits"] is True
        assert r["deltas_max"] == 0.0
        assert "src part 1 -> dst part 2" in r["fault"]
        assert r["scaling"]["n_devices"] == 4
        assert set(r["kernels"]) == {"a_interior", "b_interior",
                                     "a_boundary", "b_boundary"}
    gathered = ranks[0]["gathered"]
    assert set(gathered) == set(smoke["forms"])
    assert all(rel <= 1e-5 for _, rel in gathered.values())
    train = ranks[0]["train"]
    assert train["loss_max_rel"] <= 1e-4 and train["finite"]
    assert one["same_bits"] == {"hop": True, "train": True}
