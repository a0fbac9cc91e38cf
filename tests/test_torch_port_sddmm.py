"""The port's ``sddmm`` against the reference's XLA ``sddmm`` and its
Pallas ``sddmm_pallas`` (interpret mode, precision "f32").

On the CPU ``sddmm`` runs its plain version; kernel D itself is tested on
the card in test_torch_port_cuda.py. Tolerance: rtol = atol = 1e-5
relative to max|ref|, since only the f32 summation order over the
features differs. Padding slots must be exactly 0 on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.ops.spmm import sddmm as ref_sddmm
from sgc_tpu.ops.spmm_pallas import sddmm_pallas as ref_sddmm_pallas

from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.ops import spmm as port_spmm

TOL = 1e-5


def assert_close_rel(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max relative error {err:.3e} > {tol}"


def problem(seed, n_rows, n_cols, e, f, n_zero=0):
    """A random graph (the first ``n_zero`` edges of weight 0) and
    operands, as (reference graph, port graph on the CPU, a, b)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, e)
    cols = rng.integers(0, n_cols, e)
    vals = rng.random(e).astype(np.float32)
    vals[:n_zero] = 0.0
    rg = RefGraph.from_coo(rows, cols, vals, n_rows, n_cols, device=False)
    pg = PortGraph.from_coo(rows, cols, vals, n_rows, n_cols).to("cpu")
    a = rng.standard_normal((n_rows, f)).astype(np.float32)
    b = rng.standard_normal((n_cols, f)).astype(np.float32)
    return rg, pg, a, b


# (n_rows, n_cols, edges, F, reference chunk): square with a chunk that
# divides E_pad; rectangular; a chunk that does not divide E_pad
CASES = {
    "square": (128, 128, 800, 32, 256),
    "rectangular": (48, 80, 300, 16, 1024),
    "nondividing_chunk": (128, 128, 700, 16, 768),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sddmm_matches_reference(case):
    n_rows, n_cols, e, f, chunk = CASES[case]
    rg, pg, a, b = problem(len(case), n_rows, n_cols, e, f)
    got = port_spmm.sddmm(pg, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (pg.n_edges_padded,) and got.dtype == torch.float32
    xla = np.asarray(ref_sddmm(rg, jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(ref_sddmm_pallas(rg, jnp.asarray(a), jnp.asarray(b),
                                         chunk=chunk, interpret=True))
    assert_close_rel(got.numpy(), xla)
    assert_close_rel(got.numpy(), pallas)
    assert not got[pg.nnz:].any()           # padding slots exactly 0
    assert not pallas[pg.nnz:].any() and not xla[pg.nnz:].any()


def test_sddmm_keeps_zero_weight_true_edges():
    """Padding is positional: a genuine edge of weight 0 keeps its
    computed value, so ``with_vals(sddmm(...))`` is closed under repeated
    reweighting, as in the reference."""
    rg, pg, a, b = problem(40, 60, 60, 200, 8, n_zero=20)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = port_spmm.sddmm(pg, at, bt)
    zero_w = np.flatnonzero(pg.vals[: pg.nnz].numpy() == 0)
    assert len(zero_w) >= 20 and (got[zero_w] != 0).all()
    want = np.asarray(ref_sddmm(rg, jnp.asarray(a), jnp.asarray(b)))
    assert_close_rel(got.numpy(), want)
    again = port_spmm.sddmm(pg.with_vals(got), at, bt)
    assert torch.equal(again, got)


def test_sddmm_plain_is_chunked_and_exact(monkeypatch):
    """The plain version's edge chunking bounds memory and changes no
    bit of the result."""
    _, pg, a, b = problem(5, 90, 70, 900, 12)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    whole = port_spmm.sddmm_plain(pg, at, bt)
    monkeypatch.setattr(port_spmm, "SDDMM_PLAIN_EDGES", 100)
    assert torch.equal(port_spmm.sddmm_plain(pg, at, bt), whole)
    r, c = pg.rows[: pg.nnz].long(), pg.cols[: pg.nnz].long()
    assert torch.equal(whole[: pg.nnz], (at[r] * bt[c]).sum(-1))


@pytest.mark.parametrize("a_rows,b_rows,f_b", [(59, 60, 8), (60, 61, 8),
                                               (60, 60, 9)])
def test_sddmm_rejects_mismatched_operands(a_rows, b_rows, f_b):
    _, pg, _, _ = problem(6, 60, 60, 100, 8)
    with pytest.raises(ValueError):
        port_spmm.sddmm(pg, torch.zeros(a_rows, 8), torch.zeros(b_rows, f_b))
