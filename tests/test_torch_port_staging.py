"""Per-rank staging and sharded checkpoints against the reference.

``synthetic_features`` gives the reference's bits for any row range;
``mmap_rows`` / ``is_provider`` behave as the reference's. In one 4-rank
gloo world (``parallel.bodies.staging_checks``): ``stage_rows`` equals
``shard_features`` of the padded full matrix bit for bit on meshes (4, 1)
and (2, 2), and the gathered tiles equal the reference's ``stage_rows``
on the virtual mesh; each rank asks the provider once, for its own
part's rows only; ``save_sharded`` on (4, 1) restores onto (2, 2) and to
the host exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sgc_tpu.parallel.mesh import make_mesh as ref_mesh
from sgc_tpu.parallel import staging as ref_staging
from sgc_tpu_torch.parallel import staging
from sgc_tpu_torch.parallel.bodies import staging_checks
from sgc_tpu_torch.parallel.distributed import launch

N, F = 101, 13
N_PAD = 104
TIMEOUT_S = 180.0
SPECS = {"w": ("feat", None), "w.exp_avg": ("feat", None), "b": ()}


class _Rows:
    """A row provider over an array."""

    def __init__(self, arr):
        self._arr, self.shape, self.dtype = arr, arr.shape, arr.dtype

    def __call__(self, a, b):
        return self._arr[a:b]


@pytest.mark.parametrize("rows", [(0, 1000), (250, 500), (999, 1000),
                                  (0, 1)])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_features_are_the_reference_bits(rows, seed):
    got = staging.synthetic_features(1000, 32, seed=seed)(*rows)
    want = ref_staging.synthetic_features(1000, 32, seed=seed)(*rows)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_mmap_rows_and_is_provider(tmp_path):
    arr = np.arange(60, dtype=np.float32).reshape(12, 5)
    np.save(tmp_path / "f.npy", arr)
    p = staging.mmap_rows(tmp_path / "f.npy")
    assert staging.is_provider(p) and p.shape == (12, 5)
    np.testing.assert_array_equal(p(3, 9), arr[3:9])
    for obj in (np.zeros((4, 4)), jnp.zeros((4, 4)), lambda a, b: None):
        assert staging.is_provider(obj) == ref_staging.is_provider(obj)
    np.save(tmp_path / "v.npy", np.zeros(4))
    with pytest.raises(ValueError, match="2-D"):
        staging.mmap_rows(tmp_path / "v.npy")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("staging")
    x = np.random.default_rng(0).standard_normal((N, F)).astype(np.float32)
    np.save(root / "x.npy", x)
    rng = np.random.default_rng(1)
    state = {"w": rng.standard_normal((16, 3)).astype(np.float32),
             "w.exp_avg": rng.standard_normal((16, 3)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32),
             "w.step": np.float32(7.0)}
    out = launch(staging_checks, 4, "gloo", tmp_path_factory.mktemp("init"),
                 (str(root), {"n_rows_padded": N_PAD, "state": state,
                              "specs": SPECS}), TIMEOUT_S)
    return {"x": x, "state": state, "ranks": out}


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_stage_rows_matches_monolithic_placement(world, shape):
    name = f"{shape[0]}x{shape[1]}"
    for rank in world["ranks"]:
        assert rank["stage"][name]["equal"]
    mesh = ref_mesh(*shape)
    want = np.asarray(ref_staging.stage_rows(mesh, _Rows(world["x"]),
                                             n_rows_padded=N_PAD))
    np.testing.assert_array_equal(world["ranks"][0]["stage"][name]
                                  ["gathered"], want)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_stage_rows_reads_only_the_ranks_rows(world, shape):
    """One provider call per rank, for its own part's valid rows."""
    name = f"{shape[0]}x{shape[1]}"
    rows = N_PAD // shape[0]
    for rank, out in enumerate(world["ranks"]):
        part = rank // shape[1]
        want = [(part * rows, min((part + 1) * rows, N))]
        assert out["stage"][name]["calls"] == want


def test_sharding_report(world):
    rep = world["ranks"][0]["stage"]["2x2"]["report"]
    assert rep["global_shape"] == (N_PAD, 16)
    assert rep["n_shards"] == 4
    assert rep["per_device_gb"] == round(26 * 8 * 4 / 1e9, 3)
    assert not rep["exceeds_v5e_hbm"]
    # off a card the device capacity is not known
    assert rep["device_memory_bytes"] is None


def test_sharded_checkpoint_restores_across_meshes(world):
    for out in world["ranks"]:
        assert out["restored_2x2"]
    host = world["ranks"][0]["restored_host"]
    assert set(host) == set(world["state"])
    for k, v in world["state"].items():
        np.testing.assert_array_equal(host[k], v)
        assert host[k].dtype == np.asarray(v).dtype
