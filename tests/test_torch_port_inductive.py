"""The inductive dual-adjacency propagation (``parallel/inductive.py``)
against the reference's.

One 4-rank gloo world (``parallel.bodies.inductive_checks``) propagates
the full graph and the train subgraph over meshes (4, 1) and (2, 2),
segment and block-dense; the reference runs
``inductive_dual_propagate`` on the virtual mesh. Segment and
block-dense both hold to rtol 1e-5 / atol 1e-5 (the reference test's
tolerance against the single-device propagation); the block-dense flow
is within 2e-2 of the segment flow (the reference's own test), and the
train rows move between the two partitions as exact copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from sgc_tpu.graph.normalize import aug_normalized_adjacency
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.parallel.inductive import (
    build_dual_partition as ref_dual,
    inductive_dual_propagate as ref_propagate,
)
from sgc_tpu.parallel.mesh import make_mesh as ref_mesh
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.parallel.bodies import inductive_checks
from sgc_tpu_torch.parallel.distributed import launch, save_host
from sgc_tpu_torch.parallel.inductive import train_exchange_plan

N, E, F = 128, 900, 24
DEGREE = 2
BD = dict(n_features=F, row_block=32, stripe=32)
TIMEOUT_S = 240.0
RUNS = ("4x1/segment", "4x1/blockdense", "2x2/segment", "2x2/blockdense")


def _reddit_like(seed=3):
    """The reference test's full adjacency and train-only sub-adjacency,
    with a clustered block so that the block-dense plans admit cells."""
    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(E, np.float32), (rng.integers(0, N, E),
                                                  rng.integers(0, N, E))),
                        shape=(N, N))
    dense = sp.random(32, 32, density=0.5, random_state=seed,
                      dtype=np.float32)
    adj = (adj + adj.T + sp.block_diag([dense, sp.csr_matrix((N - 32,
                                                              N - 32))])
           ).tocsr()
    adj.data[:] = 1.0
    idx_train = np.sort(rng.choice(N, int(0.6 * N), replace=False))
    full = aug_normalized_adjacency(adj)
    train = aug_normalized_adjacency(adj[idx_train][:, idx_train])
    x = rng.standard_normal((N, F)).astype(np.float32)
    return full, train, idx_train, x


@pytest.fixture(scope="module")
def case():
    return _reddit_like()


@pytest.fixture(scope="module")
def port(case, tmp_path_factory):
    full, train, idx, x = case
    root = tmp_path_factory.mktemp("inductive")
    save_host(root / "graph", PortGraph.from_scipy(full))
    save_host(root / "train_graph", PortGraph.from_scipy(train))
    np.save(root / "x.npy", x)
    np.save(root / "idx_train.npy", idx)
    out = launch(inductive_checks, 4, "gloo",
                 tmp_path_factory.mktemp("init"),
                 (str(root), {"degree": DEGREE, "bd": BD}), TIMEOUT_S)
    assert out[1:] == [None, None, None]
    return out[0]


@pytest.fixture(scope="module")
def ref(case):
    full, train, idx, x = case
    out = {}
    for name in RUNS:
        shape, form = name.split("/")
        n_parts, n_feat = (int(v) for v in shape.split("x"))
        dual = ref_dual(RefGraph.from_scipy(full), RefGraph.from_scipy(train),
                        idx, n_parts, formulation=form,
                        **(BD if form == "blockdense" else {}))
        mesh = ref_mesh(n_parts, n_feat)
        ev, tr = jax.jit(lambda v, dual=dual, mesh=mesh: ref_propagate(
            mesh, dual, v, DEGREE))(jnp.asarray(x))
        out[name] = (np.asarray(ev), np.asarray(tr), dual)
    return out


@pytest.mark.parametrize("name", RUNS)
def test_dual_propagate_matches_reference(port, ref, name):
    ev, tr = port[name]
    ev_ref, tr_ref, dual = ref[name]
    assert ev.shape == ev_ref.shape and tr.shape == tr_ref.shape
    np.testing.assert_allclose(ev, ev_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr, tr_ref, rtol=1e-5, atol=1e-5)
    # padded rows stay zero (no leakage from padding)
    assert not ev[dual.full.n_rows:].any()
    assert not tr[dual.train.n_rows:].any()


def test_dual_blockdense_admits_cells_and_tracks_segment(port, ref):
    dual = ref["4x1/blockdense"][2]
    assert dual.full_bd.n_cells > 0 and dual.train_bd.n_cells > 0
    for shape in ("4x1", "2x2"):
        for a, b in zip(port[f"{shape}/segment"], port[f"{shape}/blockdense"]):
            scale = max(np.abs(a).max(), 1e-9)
            assert np.abs(a - b).max() / scale < 2e-2


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_train_exchange_plan_moves_every_train_row_once(parts):
    rng = np.random.default_rng(parts)
    idx = np.sort(rng.choice(N, 77, replace=False))
    fr, tr = -(-N // parts), -(-77 // parts)
    send, recv = train_exchange_plan(idx, fr, tr, parts)
    x = rng.standard_normal((fr * parts, 3)).astype(np.float32)
    got = np.zeros((tr * parts, 3), np.float32)
    seen = np.zeros(tr * parts, np.int64)
    for p in range(parts):
        for q in range(parts):
            for slot in range(send.shape[2]):
                pos = recv[p, q, slot]
                if pos >= 0:
                    got[q * tr + pos] = x[p * fr + send[p, q, slot]]
                    seen[q * tr + pos] += 1
    np.testing.assert_array_equal(got[:77], x[idx])
    assert (seen[:77] == 1).all() and not seen[77:].any()
