"""The port's serving path (``sgc_tpu_torch/serve/``, ``cli/serve.py``)
against the reference's (``sgc_tpu/serve/``, ``sgc_tpu/cli/serve.py``),
on the CPU.

The engines serve the reference's ``trained`` fixture (test_serve.py:
20-35), its head carried across with ``params_from_jax``. Tolerances:
transductive logits rtol 1e-5 / atol 1e-6 of the reference's, with equal
predictions; the int8 store and scales bit for bit, its logits to the
same f32 tolerance; the pipelined stream bit for bit against the
blocking path.
"""

import json
import sys
import threading
import urllib.error
import urllib.request
from argparse import Namespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sgc_tpu.graph.normalize import aug_normalized_adjacency
from sgc_tpu.graph.sparse import SparseGraph as RefGraph
from sgc_tpu.serve import engine as ref_engine

from sgc_tpu_torch.cli import serve as serve_cli
from sgc_tpu_torch.graph.sparse import SparseGraph as PortGraph
from sgc_tpu_torch.models.sgc import params_from_jax, sgc_apply
from sgc_tpu_torch.ops.sampling import sampled_propagate
from sgc_tpu_torch.serve import EngineConfig, InferenceEngine
from sgc_tpu_torch.serve import engine as port_engine
from sgc_tpu_torch.serve.http import serve

from test_serve import trained  # noqa: F401  (the reference's fixture)

CPU = torch.device("cpu")


def _head(params):
    return params_from_jax(np.asarray(params.w), np.asarray(params.b),
                           device=CPU)


def _pair(trained, **cfg):  # noqa: F811
    params, feats, _ = trained
    ref = ref_engine.InferenceEngine(
        params, features=feats,
        config=ref_engine.EngineConfig(min_batch=4, max_batch=32,
                                       warmup=False, **cfg))
    port = InferenceEngine(_head(params), features=feats,
                           config=EngineConfig(min_batch=4, max_batch=32,
                                               **cfg), device=CPU)
    return ref, port


def _graph_pair(n, e, seed):
    rng = np.random.default_rng(seed)
    adj = sp.coo_matrix((np.ones(e, np.float32),
                         (rng.integers(0, n, e), rng.integers(0, n, e))),
                        shape=(n, n))
    mat = aug_normalized_adjacency(adj + adj.T)
    return RefGraph.from_scipy(mat), PortGraph.from_scipy(mat)


@pytest.mark.parametrize("quantize_int8", [False, True])
def test_transductive_logits_match_reference(trained, quantize_int8):  # noqa: F811
    _, _, y = trained
    ref, port = _pair(trained, quantize_int8=quantize_int8)
    for ids in ([0, 1, 2], list(range(32)), list(range(5, 64, 3)), [63]):
        want = ref.predict_logits(ids)
        got = port.predict_logits(ids)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(port.predict(ids), ref.predict(ids))
    assert float((port.predict(list(range(32))) == y[:32]).mean()) > 0.9


def test_int8_store_is_the_reference_store(trained):  # noqa: F811
    ref, port = _pair(trained, quantize_int8=True)
    assert port._features.dtype == torch.int8
    np.testing.assert_array_equal(port._features.numpy(),
                                  np.asarray(ref._features))
    assert port._scales.dtype == torch.float32
    np.testing.assert_array_equal(port._scales.numpy(),
                                  np.asarray(ref._scales))
    f32 = InferenceEngine(port.params, features=trained[1], device=CPU,
                          config=EngineConfig(min_batch=4, max_batch=32))
    ids = list(range(32))
    np.testing.assert_array_equal(port.predict(ids), f32.predict(ids))


@pytest.mark.parametrize("lo,hi", [(8, 1024), (4, 32), (1, 1), (3, 20),
                                   (5, 5), (0, 1024), (9, 8), (-1, 4)])
def test_buckets_match_reference(lo, hi):
    try:
        want = ref_engine._buckets(lo, hi)
    except ValueError as e:
        with pytest.raises(ValueError, match="min_batch") as got:
            port_engine._buckets(lo, hi)
        assert str(got.value) == str(e)
        return
    assert port_engine._buckets(lo, hi) == want


def test_bucket_for_matches_reference(trained):  # noqa: F811
    ref, port = _pair(trained)
    for n in (1, 3, 4, 5, 8, 9, 16, 17, 31, 32):
        assert port.bucket_for(n) == ref.bucket_for(n)
    with pytest.raises(ValueError, match="exceeds max_batch 32"):
        port.bucket_for(33)
    with pytest.raises(ValueError, match="exceeds max_batch"):
        port.predict_logits(list(range(33)))


@pytest.mark.parametrize("ids,match", [
    ([1.9], "integer"), (["a"], "integer"), ([0, 64], "out of range"),
    ([-1], "out of range"), ([1.0, 2.0], None), (np.array([3, 4]), None)])
def test_prep_ids_rejects_what_the_reference_rejects(trained, ids, match):  # noqa: F811
    ref, port = _pair(trained)
    if match is None:
        n, got = port._prep_ids(ids)
        n_ref, want = ref._prep_ids(ids)
        assert n == n_ref and got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        return
    with pytest.raises(ValueError, match=match) as e_ref:
        ref._prep_ids(ids)
    with pytest.raises(ValueError, match=match) as e_port:
        port._prep_ids(ids)
    assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(ValueError, match=match):
        port.predict_logits(ids)
    with pytest.raises(ValueError, match=match):
        list(port.predict_logits_stream([[0], ids], depth=2))


def test_inductive_ids_beyond_graph_rejected(trained):  # noqa: F811
    params, feats, _ = trained
    n_graph = feats.shape[0] - 10
    rg, pg = _graph_pair(n_graph, 200, 0)
    cfg = dict(min_batch=4, max_batch=16, warmup=False)
    ref = ref_engine.InferenceEngine(params, graph=rg, raw_features=feats,
                                     config=ref_engine.EngineConfig(**cfg))
    port = InferenceEngine(_head(params), graph=pg, raw_features=feats,
                           config=EngineConfig(**cfg), device=CPU)
    assert port._n_nodes == ref._n_nodes == n_graph
    assert port.predict_logits([0, 1]).shape == (2, 3)
    with pytest.raises(ValueError, match="out of range") as e:
        port.predict_logits([n_graph])
    assert str(e.value) == f"node id {n_graph} out of range [0, {n_graph})"


def test_inductive_engine_is_the_sampled_head(trained):  # noqa: F811
    """The inductive engine's call is the head on ``sampled_propagate``
    of the bucket-padded ids under a generator seeded from the config;
    the generator advances per call."""
    params, feats, _ = trained
    _, pg = _graph_pair(feats.shape[0], 400, 1)
    head = _head(params)
    eng = InferenceEngine(head, graph=pg, raw_features=feats, device=CPU,
                          config=EngineConfig(min_batch=4, max_batch=8,
                                              fanouts=(4, 4), seed=5,
                                              warmup=False))
    got = eng.predict_logits([0, 1, 2])
    gen = torch.Generator().manual_seed(5)
    ids = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    want = sgc_apply(head, sampled_propagate(pg.to(CPU), torch.from_numpy(
        feats), ids, gen, (4, 4)))[:3].detach().numpy()
    np.testing.assert_array_equal(got, want)
    again = eng.predict_logits([0, 1, 2])
    assert np.isfinite(again).all() and not np.array_equal(again, got)


def test_stats_percentiles_match_reference():
    rng = np.random.default_rng(4)
    obs = rng.exponential(0.002, 12_345)
    ref, port = ref_engine.Stats(), port_engine.Stats()
    assert port.percentile_ms(50) == ref.percentile_ms(50) == 0.0
    for i, dt in enumerate(obs):
        ref.observe(i % 7 + 1, float(dt))
        port.observe(i % 7 + 1, float(dt))
    for q in (0, 1, 50, 90, 99, 100):
        assert port.percentile_ms(q) == ref.percentile_ms(q)
    assert port.mean_latency_ms == ref.mean_latency_ms
    assert (port.requests, port.rows) == (ref.requests, ref.rows)


def test_stream_bitwise_equal_and_ordered(trained):  # noqa: F811
    _, port = _pair(trained)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 64, size=b) for b in (7, 32, 1, 16, 32, 5)]
    blocking = [port.predict_logits(b) for b in batches]
    for depth in (1, 2, 4):
        streamed = list(port.predict_logits_stream(batches, depth=depth))
        assert len(streamed) == len(blocking)
        for got, want in zip(streamed, blocking):
            np.testing.assert_array_equal(got, want)
    outs = list(port.predict_logits_stream([[1, 2, 3], [], [10]], depth=2))
    assert [o.shape for o in outs] == [(3, 3), (0, 3), (1, 3)]
    np.testing.assert_array_equal(outs[2], port.predict_logits([10]))
    with pytest.raises(ValueError, match="depth"):
        list(port.predict_logits_stream([[0]], depth=0))
    port.stats = port_engine.Stats()
    list(port.predict_logits_stream([[1, 2]] * 5, depth=2))
    assert port.stats.requests == 5 and port.stats.rows == 10


def _max_in_flight(engine, launch_attr, batches, depth):
    """The most requests dispatched and not yet handed to the consumer,
    seen at each dispatch."""
    state = {"launched": 0, "received": 0, "max": 0}
    real = getattr(engine, launch_attr)

    def counted(*a, **k):
        state["launched"] += 1
        state["max"] = max(state["max"], state["launched"] - state["received"])
        return real(*a, **k)

    setattr(engine, launch_attr, counted)
    for _ in engine.predict_logits_stream(batches, depth=depth):
        state["received"] += 1
    return state["max"]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_keeps_at_most_depth_in_flight(trained, depth):  # noqa: F811
    """The documented contract (engine.py:324-346): at most ``depth``
    dispatches in flight. The reference's drain keeps ``depth + 1``
    (engine.py:367)."""
    ref, port = _pair(trained)
    batches = [[i, i + 1] for i in range(8)]
    assert _max_in_flight(port, "_dispatch", batches, depth) == depth
    assert _max_in_flight(ref, "_call", batches, depth) == depth + 1


def test_unported_and_provider_stores_raise(trained):  # noqa: F811
    params, feats, _ = trained
    head = _head(params)

    class Provider:
        shape = feats.shape

        def __call__(self, lo, hi):
            return feats[lo:hi]

    assert port_engine.is_provider(Provider())
    assert not port_engine.is_provider(feats)
    assert not port_engine.is_provider(torch.from_numpy(feats))
    with pytest.raises(ValueError, match="shard_store"):
        InferenceEngine(head, features=Provider(), device=CPU)
    with pytest.raises(ValueError, match="pre-quantize"):
        InferenceEngine(head, features=Provider(), device=CPU,
                        config=EngineConfig(shard_store=True,
                                            quantize_int8=True))
    for store in (feats, Provider()):
        with pytest.raises(NotImplementedError, match="distribution"):
            InferenceEngine(head, features=store, device=CPU,
                            config=EngineConfig(shard_store=True))
    _, pg = _graph_pair(feats.shape[0], 200, 2)
    with pytest.raises(ValueError, match="transductive"):
        InferenceEngine(head, graph=pg, raw_features=feats, device=CPU,
                        config=EngineConfig(shard_store=True))
    with pytest.raises(ValueError, match="transductive"):
        InferenceEngine(head, graph=pg, raw_features=feats, device=CPU,
                        config=EngineConfig(quantize_int8=True))
    with pytest.raises(ValueError, match="exactly one"):
        InferenceEngine(head, device=CPU)
    with pytest.raises(ValueError, match="raw_features"):
        InferenceEngine(head, graph=pg, device=CPU)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _status(port, path, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, path, payload)
    return e.value.code


def test_http_routes_round_trip(trained):  # noqa: F811
    params, feats, y = trained
    eng = InferenceEngine(_head(params), features=feats, device=CPU,
                          config=EngineConfig(min_batch=4, max_batch=16))
    server = serve(eng, host="127.0.0.1", port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        body = _post(port, "/predict", {"node_ids": [0, 1, 2, 3]})
        assert body["predictions"] == eng.predict([0, 1, 2, 3]).tolist()
        assert body["predictions"] == y[:4].tolist()
        body = _post(port, "/predict_logits", {"node_ids": [5, 6]})
        np.testing.assert_array_equal(np.asarray(body["logits"], np.float32),
                                      eng.predict_logits([5, 6]))
        body = _post(port, "/predict_batch",
                     {"batches": [[0, 1, 2], [], [4, 5]]})
        assert body["predictions"] == [y[:3].tolist(), [], y[4:6].tolist()]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["mode"] == "transductive"
        assert health["requests"] >= 4 and health["p99_ms"] >= 0
        assert _status(port, "/predict", {"node_ids": "nope"}) == 400
        assert _status(port, "/predict", {"node_ids": [0, 999]}) == 400
        assert _status(port, "/predict_batch", {"batches": [[0], [999]]}) \
            == 400
        assert _status(port, "/predict_batch", {"batches": "nope"}) == 400
        assert _status(port, "/nowhere", {"node_ids": [0]}) == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nowhere",
                                   timeout=30)
        assert e.value.code == 404
        # the server still answers after the errors
        assert _post(port, "/predict", {"node_ids": [7]})["predictions"] == [
            int(y[7])]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_serve_cli_starts_on_a_reference_artifact(trained, tmp_path,  # noqa: F811
                                                  monkeypatch, capsys):
    from sgc_tpu.utils.checkpoint import save_params as ref_save

    params, feats, _ = trained
    ref_save(tmp_path / "model", params)
    np.save(tmp_path / "feats.npy", feats)
    bound = {}

    def fake_forever(self):
        bound["addr"] = self.server_address
        self.server_close()

    monkeypatch.setattr("http.server.HTTPServer.serve_forever", fake_forever)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--params", str(tmp_path / "model"),
        "--features", str(tmp_path / "feats.npy"),
        "--port", "0", "--max_batch", "16", "--device", "cpu"])
    serve_cli.main()
    assert bound["addr"][1] > 0
    assert "serving 64 nodes" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve_cli.main()


def test_bench_variant_sweep(trained):  # noqa: F811
    params, feats, _ = trained
    eng = InferenceEngine(_head(params), features=feats, device=CPU,
                          config=EngineConfig(min_batch=4, max_batch=32,
                                              warmup=False))
    rows = serve_cli._bench_variant("f32", eng, [4, 32], reps=3)
    assert [r["batch"] for r in rows] == [4, 32]
    for r in rows:
        assert r["requests"] == 3 and r["variant"] == "f32"
        assert r["rows_per_s"] > 0 and r["rows_per_s_pipelined"] > 0
        assert r["p99_ms"] >= r["p50_ms"] > 0
        assert r["pipelined_bitwise_equal"] is True


def test_run_bench_on_a_small_cpu_store(capsys):
    a = Namespace(bench_nodes=2048, variants="f32,int8,inductive",
                  max_batch=64, reps=2, pipeline_depth=2)
    out = serve_cli.run_bench(a, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert out["backend"] == "cpu" and out["dispatch_floor_ms"] > 0
    assert out["store"] == {"nodes": 2048, "features": 602, "classes": 41}
    got = {(r["variant"], r["batch"]) for r in out["results"]}
    assert got == {(v, b) for v in ("f32", "int8", "inductive")
                   for b in (1, 8, 64)}
    for r in out["results"]:
        assert r.get("pipelined_bitwise_equal", True) is True
        assert ("pipelined_bitwise_equal" in r) == (r["variant"] != "inductive")
    with pytest.raises(NotImplementedError, match="distribution"):
        serve_cli.run_bench(Namespace(**{**vars(a), "variants": "shard"}),
                            device="cpu")
    with pytest.raises(SystemExit):
        serve_cli.run_bench(Namespace(**{**vars(a), "variants": "f16"}),
                            device="cpu")


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_serve_probe_passes_on_a_cpu_engine():
    """The probe's passes run on any engine (the tool itself needs a
    card) and time every pass."""
    from sgc_tpu_torch.tools import serve_probe

    feats, params = serve_cli.bench_store(512, "cpu")
    eng = InferenceEngine(params, features=feats, device=CPU,
                          config=EngineConfig(max_batch=64))
    got = serve_probe.output_cost(eng, 512, 64, 3,
                                  np.random.default_rng(0))
    assert set(got) == {"blocking_drop", "blocking_keep", "pipelined_drop",
                        "pipelined_keep"}
    assert all(v > 0 for v in got.values())
    prof = serve_probe.profile_pass(eng, [np.arange(64)] * 2, True)
    assert prof["wall_ms"] > 0 and prof["device_ms"] == 0.0
    assert prof["host_top_ms"]
