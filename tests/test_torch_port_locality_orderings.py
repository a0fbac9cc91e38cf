"""``LocalityPlan.build(ordering=name)`` for every name of the reference's
``ORDERINGS``, against the reference's plan on the same input: the
clustered Reddit-shape graph at scale 0.02 (4,659 nodes, 184,991 edges),
shuffled, the block-dense formulation in its (rb, st) cell order on both
sides. ``spectral`` runs at scale 0.01 (2,329 nodes): its shift-invert
eigensolve on the 0.02 graph takes ~14 s a package on the CPU.

* The plan's layout is equal bit for bit: ``order``, ``idx_train``,
  ``dense_fraction``, the cells' ids and bf16 bits, and the remainder's
  edges, for both hop operators.
* The two-hop rows agree within ``test_torch_port_slice.py``'s 1e-5 of
  max: both sides multiply the same bf16 cells and f32 edges, and only
  the f32 summation order differs.

``eigsh`` starts from the same seeded vector in both packages
(``test_torch_port_reorder.pin_eigsh``), since ARPACK's default start
changes from call to call.
"""

import numpy as np
import pytest
import torch

from sgc_tpu.data.synthetic import synthetic_reddit_clustered as ref_data
from sgc_tpu.graph.locality import LocalityPlan as RefPlan

from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
from sgc_tpu_torch.graph.locality import LocalityPlan
from sgc_tpu_torch.graph.reorder import ORDERINGS

from test_torch_port_reorder import pin_eigsh
from test_torch_port_slice import TOL, reference_native_lpa, rel_err


SCALE = {"spectral": 0.01}


@pytest.fixture(scope="module")
def inputs():
    cache = {}

    def at(scale):
        if scale not in cache:
            cache[scale] = (ref_data(scale, shuffle=True, device=False),
                            synthetic_reddit_clustered(scale, shuffle=True))
        return cache[scale]

    return at


def assert_split_equal(got, want):
    assert (got.n_cells, got.dense_edges, got.sparse_edges) == (
        want.n_cells, want.dense_edges, want.sparse_edges)
    np.testing.assert_array_equal(got.rb_ids, np.asarray(want.rb_ids))
    np.testing.assert_array_equal(got.st_ids, np.asarray(want.st_ids))
    np.testing.assert_array_equal(
        got.cells, np.asarray(want.cells).view(np.uint16))
    assert (got.rest is None) == (want.rest is None)
    if got.rest is not None:
        n = got.rest.nnz
        assert n == want.rest.nnz
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(
                getattr(got.rest, f)[:n], np.asarray(getattr(want.rest, f))[:n])


@pytest.mark.parametrize("name", list(ORDERINGS))
def test_plan_under_ordering_matches_reference(inputs, name, monkeypatch):
    pin_eigsh(monkeypatch)
    ref_in, port_in = inputs(SCALE.get(name, 0.02))
    if name == "lpa":
        with reference_native_lpa():
            ref = RefPlan.build(*ref_in, ordering=name,
                                formulation="blockdense")
    else:
        ref = RefPlan.build(*ref_in, ordering=name, formulation="blockdense")
    port = LocalityPlan.build(*port_in, ordering=name,
                              formulation="blockdense", device="cpu")
    np.testing.assert_array_equal(port.order, ref.order)
    np.testing.assert_array_equal(port.idx_train, ref.idx_train)
    np.testing.assert_array_equal(port.features, ref.features)
    assert port.dense_fraction == ref.dense_fraction
    assert_split_equal(port.split_main, ref.split_main)
    assert_split_equal(port.split_final, ref.split_final)
    assert port.prep_seconds["order_s"] > 0
    want = np.asarray(ref.propagate_train(2, precision="f32"))
    got = port.propagate_train(2, precision="f32")
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= TOL
