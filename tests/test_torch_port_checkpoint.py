"""The port's params and per-hop checkpoints
(``sgc_tpu_torch/utils/checkpoint.py``) against the reference's
(``sgc_tpu/utils/checkpoint.py``), on the CPU.

A head saved by either package loads in the other (the reference with
``like=``, since the port writes no pickled ``.treedef``), with the same
bits; the restart fingerprint is the reference's digest for the same
graph and features; a resumed propagation equals an uninterrupted one
bit for bit, and a checkpoint written by one package restores in the
other.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from sgc_tpu.graph.normalize import aug_normalized_adjacency
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.models.sgc import SGCParams
from sgc_tpu.models.sgc import init_sgc as ref_init
from sgc_tpu.utils import checkpoint as ref

from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.models.sgc import SGC, params_from_jax
from sgc_tpu_torch.ops import spmm as port_spmm
from sgc_tpu_torch.utils import checkpoint as port

CPU = torch.device("cpu")


def _ref_head(bias):
    return ref_init(jax.random.PRNGKey(3), 12, 4, bias=bias)


def _assert_same_head(port_head, ref_head):
    np.testing.assert_array_equal(port_head.w.detach().numpy(),
                                  np.asarray(ref_head.w))
    if ref_head.b is None:
        assert port_head.b is None
    else:
        np.testing.assert_array_equal(port_head.b.detach().numpy(),
                                      np.asarray(ref_head.b))


@pytest.mark.parametrize("bias", [True, False])
def test_reference_head_loads_in_the_port(tmp_path, bias):
    p = _ref_head(bias)
    ref.save_params(tmp_path / "model", p)
    assert (tmp_path / "model.treedef").exists()
    got = port.load_params(tmp_path / "model", device=CPU)
    assert isinstance(got, SGC) and not got.w.requires_grad
    _assert_same_head(got, p)
    like = params_from_jax(np.zeros((12, 4)), np.zeros(4) if bias else None,
                           device=CPU)
    _assert_same_head(port.load_params(tmp_path / "model.npz", like=like,
                                       device=CPU), p)


@pytest.mark.parametrize("bias", [True, False])
def test_port_head_loads_in_the_reference(tmp_path, bias):
    p = _ref_head(bias)
    head = params_from_jax(np.asarray(p.w),
                           None if p.b is None else np.asarray(p.b),
                           device=CPU)
    port.save_params(tmp_path / "head.npz", head)
    assert not (tmp_path / "head.treedef").exists()
    like = SGCParams(w=jnp.zeros((12, 4)),
                     b=jnp.zeros(4) if bias else None)
    back = ref.load_params(tmp_path / "head.npz", like=like)
    _assert_same_head(head, back)
    assert np.asarray(back.w).dtype == np.float32
    # and round trip through the port itself
    _assert_same_head(port.load_params(tmp_path / "head.npz", device=CPU), p)


def test_load_params_checks_the_structure(tmp_path):
    ref.save_params(tmp_path / "m", _ref_head(True))
    no_bias = params_from_jax(np.zeros((12, 4)), None, device=CPU)
    with pytest.raises(ValueError, match="leaves"):
        port.load_params(tmp_path / "m", like=no_bias, device=CPU)
    np.savez(tmp_path / "three.npz", leaf_0=np.zeros(2), leaf_1=np.zeros(2),
             leaf_2=np.zeros(2))
    with pytest.raises(ValueError, match="3 leaves"):
        port.load_params(tmp_path / "three.npz", device=CPU)


def _graphs(n=60, seed=0):
    a = sp.random(n, n, density=0.1, random_state=seed, format="coo",
                  dtype=np.float32)
    mat = aug_normalized_adjacency(a + a.T)
    return RefGraph.from_scipy(mat), PortGraph.from_scipy(mat).to(CPU)


def _x(n=60, f=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


@pytest.mark.parametrize("degree", [1, 3])
def test_fingerprint_equals_the_reference(degree):
    rg, pg = _graphs()
    x = _x()
    fp = port.propagation_fingerprint(pg, torch.from_numpy(x), degree)
    assert fp == ref.propagation_fingerprint(rg, jnp.asarray(x), degree)
    # the host graph (numpy arrays) and numpy features digest the same
    host_graph = PortGraph.from_scipy(pg.to_scipy().tocsr())
    assert host_graph.device is None
    assert fp == port.propagation_fingerprint(host_graph, x, degree)
    # content-aware: edge values or features that differ in value only
    assert fp != port.propagation_fingerprint(
        pg.with_vals(pg.vals * 2.0), torch.from_numpy(x), degree)
    x2 = x.copy()
    x2[0, 0] += 1.0
    assert fp != port.propagation_fingerprint(pg, torch.from_numpy(x2),
                                              degree)


def test_resumed_propagation_equals_uninterrupted(tmp_path, monkeypatch):
    rg, pg = _graphs()
    x = torch.from_numpy(_x())
    full = port.propagate_with_checkpoints(x, pg, 3, tmp_path / "full")
    straight = port_spmm.spmm(pg, port_spmm.spmm(pg, port_spmm.spmm(pg, x)))
    assert torch.equal(full, straight)
    ckpt = port.PropagationCheckpointer(
        tmp_path / "full", port.propagation_fingerprint(pg, x, 3))
    restored, nxt = ckpt.restore(x)
    assert nxt == 3 and torch.equal(restored, full)
    assert sorted(p.name for p in (tmp_path / "full").iterdir()) == [
        "hop_2.npz", "meta.json"]

    # a run stopped after its first hop resumes at the second
    fp = port.propagation_fingerprint(pg, x, 3)
    part = port.PropagationCheckpointer(tmp_path / "part", fp)
    part.save_hop(0, port_spmm.spmm(pg, x))
    calls = []
    real = port_spmm.spmm

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_spmm, "spmm", spy)
    resumed = port.propagate_with_checkpoints(x, pg, 3, tmp_path / "part")
    assert len(calls) == 2, f"resume ran {len(calls)} hops, not 2"
    assert torch.equal(resumed, full)
    # the reference's propagation agrees to f32 rounding
    want = np.asarray(ref.propagate_with_checkpoints(jnp.asarray(x.numpy()),
                                                     rg, 3))
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    rg, pg = _graphs(seed=1)
    x = _x(seed=1)
    hop0 = port_spmm.spmm(pg, torch.from_numpy(x))
    fp = port.propagation_fingerprint(pg, torch.from_numpy(x), 2)
    if writer == "port":
        port.PropagationCheckpointer(tmp_path, fp).save_hop(0, hop0)
        got, nxt = ref.PropagationCheckpointer(tmp_path, fp).restore(
            jnp.asarray(x))
        got = np.asarray(got)
    else:
        ref.PropagationCheckpointer(tmp_path, fp).save_hop(
            0, jnp.asarray(hop0.numpy()))
        got, nxt = port.PropagationCheckpointer(tmp_path, fp).restore(
            torch.from_numpy(x))
        got = got.numpy()
    assert nxt == 1
    np.testing.assert_array_equal(got, hop0.numpy())


@pytest.mark.parametrize("meta", ['{"fingerprint": "k2_', "", "{}",
                                  '{"fingerprint": "other", "last_hop": 0}'])
def test_half_written_or_foreign_meta_reads_as_no_checkpoint(tmp_path,
                                                             meta):
    _, pg = _graphs()
    x = torch.from_numpy(_x())
    fp = port.propagation_fingerprint(pg, x, 2)
    ckpt = port.PropagationCheckpointer(tmp_path, fp)
    ckpt.save_hop(0, port_spmm.spmm(pg, x))
    (tmp_path / "meta.json").write_text(meta)
    got, nxt = ckpt.restore(x)
    assert nxt == 0 and got is x
    # and the run starts from scratch, ending where an uninterrupted run
    # ends
    out = port.propagate_with_checkpoints(x, pg, 2, tmp_path)
    assert torch.equal(out, port_spmm.spmm(pg, port_spmm.spmm(pg, x)))
    assert json.loads((tmp_path / "meta.json").read_text()) == {
        "fingerprint": fp, "last_hop": 1}


def test_missing_hop_file_reads_as_no_checkpoint(tmp_path):
    _, pg = _graphs()
    x = torch.from_numpy(_x())
    fp = port.propagation_fingerprint(pg, x, 2)
    ckpt = port.PropagationCheckpointer(tmp_path, fp)
    ckpt.save_hop(1, x)
    (tmp_path / "hop_1.npz").unlink()
    got, nxt = ckpt.restore(x)
    assert nxt == 0 and got is x
