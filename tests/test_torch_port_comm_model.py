"""The host-only communication models of ``parallel/scaling.py`` return
the reference's dicts (every key but the measured ``plan_build_s``), and
``init_distributed`` keeps the reference's bring-up rules."""

import numpy as np
import pytest
import torch.distributed as dist

from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.parallel import scaling as ref_scaling
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.parallel import scaling as port_scaling


def _coo(kind, n=512, e=4000, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    if kind == "clustered":
        block = n // 8
        cols = (rows // block) * block + rng.integers(0, block, e)
        far = rng.random(e) < 0.1
        cols[far] = rng.integers(0, n, int(far.sum()))
    else:
        cols = rng.integers(0, n, e)
    return rows, cols, np.ones(e, np.float32), n


def _pair(kind, **kw):
    r, c, v, n = _coo(kind, **kw)
    return (RefGraph.from_coo(r, c, v, n, n),
            PortGraph.from_coo(r, c, v, n, n))


def _without_timing(d):
    return {k: v for k, v in d.items() if k != "plan_build_s"}


@pytest.mark.parametrize("kind", ["random", "clustered"])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("build_plan", [True, False])
def test_comm_model_matches_reference(kind, P, build_plan):
    rg, pg = _pair(kind)
    for rate in (1e4, 1.5e8):
        want = ref_scaling.comm_model(rg, 64, P, rate, build_plan=build_plan)
        got = port_scaling.comm_model(pg, 64, P, rate, build_plan=build_plan)
        assert _without_timing(got) == _without_timing(want)
        assert got["plan_build_s"] >= 0.0


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_halo_width_model_matches_reference(kind):
    rg, pg = _pair(kind, n=600, e=5000, seed=3)
    for P in (2, 3, 4, 8, 16):
        assert port_scaling.halo_width_model(pg, P) == \
            ref_scaling.halo_width_model(rg, P)
    # no remote edge at all: the minimum width
    r = np.arange(64)
    g = PortGraph.from_coo(r, r, np.ones(64, np.float32), 64, 64)
    assert port_scaling.halo_width_model(g, 4) == (8, 64)


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_comm_sweep_matches_reference(kind):
    rg, pg = _pair(kind, n=512, e=8000, seed=10)
    for kw in ({}, {"device_counts": (2, 4), "target": 0.95,
                    "fabrics": {"a": 5.0, "b": 500.0}}):
        assert port_scaling.comm_sweep(pg, 256, 1.5e8, **kw) == \
            ref_scaling.comm_sweep(rg, 256, 1.5e8, **kw)


@pytest.mark.parametrize("kind", ["random", "clustered"])
@pytest.mark.parametrize("hosts,per_host", [(2, 4), (4, 2), (1, 4)])
def test_comm_model_two_level_matches_reference(kind, hosts, per_host):
    rg, pg = _pair(kind, seed=9)
    want = ref_scaling.comm_model_two_level(rg, 64, hosts, per_host, 1e8)
    got = port_scaling.comm_model_two_level(pg, 64, hosts, per_host, 1e8)
    assert _without_timing(got) == _without_timing(want)


def test_fabric_constants_are_the_references():
    assert port_scaling.V5E_ICI_GBPS == ref_scaling.V5E_ICI_GBPS
    assert port_scaling.V5E_DCN_GBPS == ref_scaling.V5E_DCN_GBPS


def test_init_distributed_single_process_and_bad_rendezvous(monkeypatch,
                                                            tmp_path):
    for k in port_scaling.RENDEZVOUS_ENV:
        monkeypatch.delenv(k, raising=False)
    assert port_scaling.init_distributed() is False
    assert not dist.is_initialized()
    # a rendezvous named without a backend is refused, not guessed
    with pytest.raises(ValueError, match="backend"):
        port_scaling.init_distributed(f"file://{tmp_path}/s", 1, 0)
    # a peer that never joins is a bring-up failure: it raises at the
    # deadline instead of carrying on as a single process
    with pytest.raises(RuntimeError):
        port_scaling.init_distributed(f"file://{tmp_path}/store", 2, 0,
                                      backend="gloo", timeout_s=2.0)
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="backend"):
        port_scaling.init_distributed()
