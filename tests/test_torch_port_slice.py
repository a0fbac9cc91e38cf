"""The port's main path as a whole at scale 0.02 (4,659 nodes, 184,991
edges: 42 dense cells and 17,890 remainder edges in the main split, so
both kernels' paths run), against the reference on the same inputs.

* propagation: the port's ``khop_traceable(degree=2)`` on the CPU vs the
  reference's ``blockdense_pallas`` plan in interpret mode, rtol = atol =
  1e-5 relative to max|ref| (only the f32 summation order differs);
* the Newton head (8 steps) from the reference's ``init_sgc(PRNGKey(42))``
  carried over by ``params_from_jax``: w, b and loss within 1e-4;
* the LBFGS oracle's loss within 5e-4 (the bound
  tests/test_lbfgs_torch_oracle.py uses for the same comparison).
"""

import contextlib
import fcntl
import os
import tempfile
import time
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgc_tpu import native as ref_native
from sgc_tpu.data.synthetic import synthetic_reddit_clustered as ref_data
from sgc_tpu.graph.locality import LocalityPlan as RefPlan
from sgc_tpu.models.sgc import init_sgc as ref_init
from sgc_tpu.models.sgc import sgc_apply as ref_apply
from sgc_tpu.train import loops as ref_loops

from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
from sgc_tpu_torch.graph.locality import LocalityPlan
from sgc_tpu_torch.models.sgc import params_from_jax, sgc_apply
from sgc_tpu_torch.train import loops as port_loops

TOL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@contextlib.contextmanager
def reference_native_lpa(timeout: float = 60.0):
    """Hold the reference's native LPA solver for the block. Parallel
    workers build the reference's host library in place, unlocked, so a
    worker can load a half-written file, latch the failure and fall back
    to its numpy LPA, a different fixpoint. Under a file lock, clear the
    latch and retry until the library loads (fail the test if it never
    does); inside the block the fallback's warning is an error."""
    path = os.path.join(tempfile.gettempdir(), "sgc_tpu_native_ref.lock")
    with open(path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + timeout
        while not ref_native.available():
            if time.monotonic() > deadline:
                pytest.fail("the reference's native library does not load;"
                            " its numpy LPA is not a reference for the port")
            ref_native._lib, ref_native._load_failed = None, False
            time.sleep(0.5)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="lpa_order: native library")
        yield


@pytest.fixture(scope="module")
def plans():
    with reference_native_lpa():
        ref = RefPlan.build(*ref_data(0.02, shuffle=True, device=False),
                            formulation="blockdense_pallas")
    port = LocalityPlan.build(*synthetic_reddit_clustered(0.02, shuffle=True),
                              formulation="blockdense_kernel", device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def ref_propagated(plans):
    ref = plans[0]
    khop, args = ref.khop_traceable(degree=2, interpret=True)
    return np.asarray(khop(jnp.asarray(ref.features), args))


@pytest.fixture(scope="module")
def head_problem(plans, ref_propagated):
    ref = plans[0]
    y = ref.labels[ref.idx_train].astype(np.int32)
    n_classes = int(ref.labels.max()) + 1
    p0 = ref_init(jax.random.PRNGKey(42), ref_propagated.shape[1], n_classes)
    return ref_propagated, y, n_classes, p0


def test_plan_matches_reference_layout(plans):
    ref, port = plans
    assert port.formulation == "blockdense_kernel"
    assert port.split_main.super_rows == ref.split_main.super_rows == 8
    np.testing.assert_array_equal(ref.order, port.order)
    np.testing.assert_array_equal(ref.idx_train, port.idx_train)
    assert port.dense_fraction == ref.dense_fraction
    s = port.split_main
    assert (s.n_cells, s.sparse_edges, port.split_final.n_cells) == (
        42, 17890, 22)
    assert set(port.prep_seconds) == {"order_s", "subgraph_s", "split_s"}


def test_khop_matches_reference_pallas_interpret(plans, ref_propagated):
    port = plans[1]
    khop, args = port.khop_traceable(degree=2)
    got = khop(torch.as_tensor(port.features), args)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), ref_propagated) <= TOL
    # propagate_train is the same computation
    assert torch.equal(port.propagate_train(2), got)


@pytest.mark.parametrize("degree", [1, 3])
def test_khop_degrees_match_reference(plans, degree):
    ref, port = plans
    khop, args = ref.khop_traceable(degree=degree, interpret=True)
    want = np.asarray(khop(jnp.asarray(ref.features), args))
    assert rel_err(port.propagate_train(degree).numpy(), want) <= TOL


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_hop_fns_match_reference_at_precision(plans, precision):
    """Both hop operators and ``khop_traceable`` at each precision
    against the reference's (``blockdense_pallas`` in interpret mode), on
    the same inputs, so both sides round the same x to bf16; the closures
    are cached per precision. At bf16 the second hop is held on the
    first-hop rows of the reference's own ``khop`` (its un-jitted hop
    form): rows whose last bits differ, as the port's do, or the
    reference's jitted hop's (1.6e-7 of max apart), flip some bf16(x)
    values by a bf16 ulp (2**-8), which moves the reference's own
    two-hop rows by 4.2e-5 of max here."""
    ref, port = plans
    x_ref = jnp.asarray(ref.features)
    x = torch.as_tensor(port.features)
    ref_fns = ref.hop_fns(precision=precision, interpret=True)
    port_fns = port.hop_fns(precision)
    assert port.hop_fns(precision) is port_fns
    for want_fn, got_fn in zip(ref_fns, port_fns):
        assert rel_err(got_fn(x).numpy(), np.asarray(want_fn(x_ref))) <= TOL
    khop, args = ref.khop_traceable(degree=1, precision=precision,
                                    interpret=True)
    want = np.asarray(khop(x_ref, args))
    got = port.propagate_train(1, precision=precision)
    assert rel_err(got.numpy(), want) <= TOL
    khop, args = ref.khop_traceable(degree=2, precision=precision,
                                    interpret=True)
    want = np.asarray(khop(x_ref, args))
    if precision == "f32":
        got = port.propagate_train(2, precision=precision)
    else:
        full = ref._spmm_form(ref.split_main, precision, True)
        x1 = np.asarray(full(x_ref, args[0]))
        got = port_fns[1](torch.from_numpy(x1))
    assert rel_err(got.numpy(), want) <= TOL


def test_plain_formulation_matches_kernel_form(plans):
    """``blockdense`` (plain) and ``blockdense_kernel`` give the same rows;
    ``auto`` resolves to the plain form on the CPU."""
    port = plans[1]
    data = synthetic_reddit_clustered(0.02, shuffle=True)
    plain = LocalityPlan.build(*data, formulation="auto", device="cpu")
    assert plain.formulation == "blockdense"
    assert plain.split_main.super_rows is None
    got = plain.propagate_train(2)
    assert rel_err(got.numpy(), port.propagate_train(2).numpy()) <= TOL


def test_propagate_all_restores_original_ids(plans):
    ref, port = plans
    want = np.asarray(ref.propagate_all(degree=1, interpret=True))
    got = port.propagate_all(degree=1)
    assert rel_err(got.numpy(), want) <= TOL
    raw = port.propagate_all(degree=1, restore=False).numpy()
    np.testing.assert_array_equal(port.restore_rows(raw), got.numpy())


def test_newton_head_matches_reference(head_problem):
    tr, y, n_classes, p0 = head_problem
    wd = 1e-5
    cw = jnp.ones((n_classes,), jnp.float32)
    ref_p, ref_loss = ref_loops._newton_linear_fit(
        p0, jnp.asarray(tr), jnp.asarray(y), jnp.asarray(wd, jnp.float32),
        cw, 8, False, False)
    model = params_from_jax(np.asarray(p0.w), np.asarray(p0.b), device="cpu")
    fit, loss = port_loops._newton_linear_fit(
        model, torch.from_numpy(tr.copy()), torch.from_numpy(y), wd,
        torch.ones(n_classes), 8, False, False)
    assert rel_err(fit.w.numpy(), ref_p.w) <= 1e-4
    assert rel_err(fit.b.numpy(), ref_p.b) <= 1e-4
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    # the fitted heads classify the train rows alike
    got = sgc_apply(fit, torch.from_numpy(tr.copy())).argmax(1).numpy()
    want = np.asarray(jnp.argmax(ref_apply(ref_p, jnp.asarray(tr)), 1))
    assert (got == want).mean() > 0.999


def test_lbfgs_oracle_matches_reference(head_problem):
    tr, y, n_classes, p0 = head_problem
    wd = 1e-2   # a well-posed problem: at wd 1e-5 both LBFGS runs diverge
    cw = jnp.ones((n_classes,), jnp.float32)
    _, ref_loss = ref_loops._lbfgs_linear_fit(
        p0, jnp.asarray(tr), jnp.asarray(y), jnp.asarray(wd, jnp.float32),
        cw, 2, False, False, 1.0)
    model = params_from_jax(np.asarray(p0.w), np.asarray(p0.b), device="cpu")
    w_before = model.w.detach().clone()
    _, loss = port_loops._lbfgs_linear_fit(
        model, torch.from_numpy(tr.copy()), torch.from_numpy(y), wd,
        torch.ones(n_classes), 2, False, False, 1.0)
    assert abs(float(loss) - float(ref_loss)) <= 5e-4 * abs(float(ref_loss))
    assert torch.equal(model.w, w_before)      # the input head is untouched


@pytest.mark.parametrize("binary,weighted", [
    (False, True), (True, False), (True, True)])
def test_newton_variants_match_reference(binary, weighted):
    rng = np.random.default_rng(8)
    n, f, c = 400, 12, 1 if binary else 5
    labels = rng.integers(0, 2 if binary else c, n).astype(np.int32)
    centers = rng.standard_normal((max(c, 2), f))
    x = (centers[labels] + rng.standard_normal((n, f))).astype(np.float32)
    n_w = 2 if binary else c
    cw = (0.5 + rng.random(n_w)).astype(np.float32)
    p0 = ref_init(jax.random.PRNGKey(1), f, c)
    wd = 1e-3
    ref_p, ref_loss = ref_loops._newton_linear_fit(
        p0, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(wd, jnp.float32),
        jnp.asarray(cw), 8, binary, weighted)
    fit, loss = port_loops._newton_linear_fit(
        params_from_jax(np.asarray(p0.w), np.asarray(p0.b), device="cpu"),
        torch.from_numpy(x), torch.from_numpy(labels), wd,
        torch.from_numpy(cw), 8, binary, weighted)
    assert rel_err(fit.w.numpy(), ref_p.w) <= 1e-4
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((50, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 50).astype(np.int32)
    cw = (0.5 + rng.random(7)).astype(np.float32)
    for w in (None, cw):
        want = float(ref_loops.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if w is None else jnp.asarray(w)))
        got = float(port_loops.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w)))
        assert abs(got - want) <= 1e-6 * abs(want)
