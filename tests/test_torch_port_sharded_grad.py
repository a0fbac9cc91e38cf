"""Backward of the sharded hops (``parallel/autograd.py``).

One 4-rank gloo world (``parallel.bodies.grad_checks``) takes the
gradient of ``<S^K x, g>`` with respect to x through every hop form
(all-gather, halo, overlapped halo, each with and without ``edge_chunk``;
block-dense at ``"f32"`` and ``"bf16"``) on meshes (4, 1) and (2, 2), and
on a 22-node graph whose last part is short and another empty. It is
held against autograd through the dense operator on one process
(``(S^T)^K g``) at rtol 1e-5; the block-dense forms against the operator
their cells store (admitted edges rounded to bf16), at ``"f32"`` to
rtol 1e-5 and at ``"bf16"`` (g rounded as x is) to the reference's test
tolerance, rtol 2e-2 and atol 1e-3; both precisions also against the
reference's own gradient through its sharded block-dense hop
(``jax.vjp`` on the virtual mesh): 1e-5 at ``"f32"``, the bf16
tolerance at ``"bf16"``, where JAX's transpose rounds the product
``C^T g`` to bf16 and the port rounds g. A second backward gives the
same bits; ``col_chunk``'s backward equals the unpaneled one bit for
bit; padded send slots carry exact zeros back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.parallel import make_mesh as ref_mesh
from sgc_tpu.parallel import partition_graph as ref_partition
from sgc_tpu.parallel.blockdense import build_sharded_blockdense
from sgc_tpu.parallel.halo import build_halo
from sgc_tpu.parallel.partition import pad_node_rows
from sgc_tpu.parallel.spmm import propagate_sharded, shard_features
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.parallel.bodies import (
    GRAD_FORMS,
    blockdense_operator_vals,
    grad_checks,
    write_inputs,
    write_plans,
)
from sgc_tpu_torch.parallel.distributed import launch

N, F = 150, 24
DEGREE = 2
EDGE_CHUNK = 128
COL_CHUNK = 10
BD = dict(n_features=F, row_block=32, stripe=32, min_edges=30.0)
SHORT_BD = dict(n_features=F, row_block=8, stripe=8, min_edges=3.0)
TIMEOUT_S = 300.0
MESHES = ("4x1", "2x2", "short/4x1")


def _normalized(a):
    a = ((a + a.T + sp.eye(a.shape[0])) > 0).astype(np.float32)
    d = np.asarray(a.sum(axis=1)).ravel() ** -0.5
    return (sp.diags(d) @ a @ sp.diags(d)).astype(np.float32).tocsr()


def _data():
    """Dense diagonal communities with sparse crossings (interior and
    boundary cells and remainders), as SGC's operator."""
    rng = np.random.default_rng(17)
    blocks = [sp.random(s, s, density=0.45, dtype=np.float32,
                        random_state=int(rng.integers(1 << 30)))
              for s in (38, 37, 38, 37)]
    cross = sp.random(N, N, density=0.03, dtype=np.float32,
                      random_state=int(rng.integers(1 << 30)))
    a = _normalized(sp.block_diag(blocks) + cross)
    x = rng.standard_normal((N, F)).astype(np.float32)
    g = rng.standard_normal((N, F)).astype(np.float32)
    return a, x, g


def _short_data():
    rng = np.random.default_rng(19)
    a = _normalized(sp.random(22, 22, density=0.3, dtype=np.float32,
                              random_state=19))
    return (a, rng.standard_normal((22, F)).astype(np.float32),
            rng.standard_normal((22, F)).astype(np.float32))


def _write(root, a, x, g, parts, bd_kw):
    graph = PortGraph.from_scipy(a)
    write_inputs(root, graph, x, np.zeros(a.shape[0], np.int64),
                 np.arange(a.shape[0]))
    np.save(root / "g.npy", g)
    return graph, write_plans(root, graph, parts, **bd_kw)["plans"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("grad")
    a, x, g = _data()
    graph, plans = _write(root, a, x, g, {4: True, 2: True}, BD)
    short = tmp_path_factory.mktemp("grad_short")
    sa, sx, sg = _short_data()
    sgraph, splans = _write(short, sa, sx, sg, {4: True}, SHORT_BD)
    bd4 = plans[4][2]
    assert bd4.part_cells_int.sum() > 0 and bd4.part_cells_bnd.sum() > 0
    assert int(np.count_nonzero(splans[4][0].vals[3])) == 0  # empty part
    out = launch(grad_checks, 4, "gloo", tmp_path_factory.mktemp("init"),
                 (str(root), {"degree": DEGREE, "edge_chunk": EDGE_CHUNK,
                              "col_chunk": COL_CHUNK,
                              "short_dir": str(short)}), TIMEOUT_S)
    assert out[1:] == [None, None, None]
    return {"port": out[0], "4x1": (a, x, g, graph, plans[4]),
            "2x2": (a, x, g, graph, plans[2]),
            "short/4x1": (sa, sx, sg, sgraph, splans[4])}


def _dense_grad(a, g) -> np.ndarray:
    """``d <(A)^K x, g> / dx`` by torch autograd through the dense A."""
    dense = torch.tensor(a.toarray(), dtype=torch.float32)
    x = torch.zeros((a.shape[1], g.shape[1]), requires_grad=True)
    y = x
    for _ in range(DEGREE):
        y = dense @ y
    y.backward(torch.from_numpy(g))
    return x.grad.numpy()


def _bd_operator(graph, plans):
    pg, ho, bd = plans
    vals = blockdense_operator_vals(graph, pg, ho, bd)
    n = graph.nnz
    return sp.csr_matrix((vals, (graph.rows[:n], graph.cols[:n])),
                         shape=graph.shape)


@pytest.mark.parametrize("form", GRAD_FORMS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_backward_matches_dense_autograd(case, mesh_name, form):
    a, x, g, graph, plans = case[mesh_name]
    got = case["port"]["grads"][f"{mesh_name}/{form}"]
    n = a.shape[0]
    assert not got[n:].any()          # padded rows get no gradient
    if form.startswith("blockdense"):
        a = _bd_operator(graph, plans)
    want = _dense_grad(a, g)
    if form == "blockdense_bf16":
        # g rounded to bf16 in the cell term, as the forward rounds x
        np.testing.assert_allclose(got[:n], want, rtol=2e-2, atol=1e-3)
    else:
        np.testing.assert_allclose(got[:n], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("mesh_name", ["4x1", "2x2"])
def test_blockdense_backward_matches_reference_vjp(case, mesh_name,
                                                   precision):
    """The reference's gradient through its sharded block-dense hop
    (JAX's transpose of the shard_map, on the virtual mesh)."""
    a, x, g, *_ = case[mesh_name]
    shape = tuple(int(v) for v in mesh_name.split("x"))
    mesh = ref_mesh(*shape)
    pg = ref_partition(RefGraph.from_scipy(a), shape[0])
    bd = build_sharded_blockdense(pg, build_halo(pg), **BD)

    def pad(v):
        return shard_features(mesh, pad_node_rows(jnp.asarray(v),
                                                  pg.n_rows_padded))

    @jax.jit
    def grad(v, cot):
        _, vjp = jax.vjp(lambda u: propagate_sharded(
            mesh, pg, u, DEGREE, blockdense=bd, precision=precision), v)
        return vjp(cot)[0]

    want = np.asarray(grad(pad(x), pad(g)))
    if precision == "f32":
        got = case["port"]["grads"][f"{mesh_name}/blockdense"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # JAX's transpose rounds the product C^T g to bf16, the port
        # rounds g: both within the reference's bf16 tolerance
        got = case["port"]["grads"][f"{mesh_name}/blockdense_bf16"]
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("form", GRAD_FORMS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_sharded_backward_same_bits_twice(case, mesh_name, form):
    assert case["port"]["same_bits"][f"{mesh_name}/{form}"]


def test_col_chunk_backward_same_bits(case):
    assert case["port"]["col_chunk_same_bits"]


def test_padded_send_slots_carry_exact_zeros(case):
    check = case["port"]["padded_slots_zero"]
    assert check["slots"] > 0
    assert check["zero"]
