"""The distributed entry points against the reference's: ``cli.citation
--sharded`` (SGC with both trainers, and GCN), ``cli.reddit --sharded``
(transductive and ``--inductive``, against the unsharded run, which
tests/test_torch_port_reddit.py holds against the reference's),
``cli.scaling`` (the reference's JSON contract, tests/test_parallel.py)
and ``cli.dist_demo`` (launcher and TCP workers). The port's worlds are gloo ranks on the CPU, as many
as ``SGC_TPU_TORCH_CPU_RANKS`` names; the reference runs on the virtual
8-device mesh. (``cli.serve --bench --variants shard`` is driven in
tests/test_torch_port_serve.py.)

The two packages train the same models from different random draws and
over different meshes, so the checks are the reference's own: its output
keys, accuracies within a few points of each other (and of the unsharded
run), the propagated features to bf16 rounding.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sgc_tpu.cli import citation as ref_citation
from sgc_tpu.utils.config import CitationConfig as RefConfig
from sgc_tpu_torch.cli import citation as port_citation
from sgc_tpu_torch.cli import dist_demo, scaling
from sgc_tpu_torch.cli import reddit as port_reddit
from sgc_tpu_torch.data.fixtures import write_planetoid, write_reddit
from sgc_tpu_torch.parallel.distributed import CPU_RANKS_ENV
from sgc_tpu_torch.utils.config import CitationConfig

from tests.conftest import REPO_ROOT

CPU = "cpu"
RANKS = 2
DEMO = ["--nodes", "512", "--edges", "4000", "--features", "16",
        "--epochs", "4", "--device", "cpu", "--timeout", "300"]


@pytest.fixture(autouse=True)
def cpu_ranks(monkeypatch):
    monkeypatch.setenv(CPU_RANKS_ENV, str(RANKS))


@pytest.fixture(scope="module")
def planetoid_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("planetoid")
    write_planetoid(root, "cora", 900, 3000, 60, 4, 28, 200, seed=1)
    return root


@pytest.fixture(scope="module")
def reddit_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("reddit")
    write_reddit(root, scale=0.01, seed=3)
    return root


@pytest.mark.parametrize("model", ["SGC", "GCN"])
def test_citation_sharded_matches_reference(planetoid_root, model):
    kw = dict(model=model, epochs=60, lr=0.2 if model == "SGC" else 0.01)
    want = ref_citation.run(RefConfig(dataset="cora", **kw),
                            str(planetoid_root), sharded=True)
    got = port_citation.run(CitationConfig(dataset="cora", **kw),
                            str(planetoid_root), sharded=True, device=CPU)
    assert set(got) == set(want)
    for k in ("val_accuracy", "test_accuracy"):
        assert abs(got[k] - want[k]) <= 0.05, (k, got[k], want[k])
        assert got[k] > 0.6
    if model == "SGC":
        # the reference's 8 devices give 4 parts, the port's ranks 2:
        # the fraction is the reference plan's at the port's part count
        from sgc_tpu.data.planetoid import load_citation
        from sgc_tpu.parallel.halo import build_halo, halo_fraction
        from sgc_tpu.parallel.partition import partition_graph

        pg = partition_graph(load_citation("cora", "AugNormAdj", str(
            planetoid_root)).graph, RANKS)
        assert got["formulation"] == want["formulation"]
        assert got["halo_fraction"] == halo_fraction(build_halo(pg), pg)
    else:
        assert np.isfinite(got["final_loss"])


def test_citation_sharded_newton_trainer(planetoid_root, monkeypatch,
                                        capsys):
    """``main`` with ``--sharded --trainer newton`` prints the reference's
    two lines, and its head classifies as the unsharded Adam head does."""
    plain = port_citation.run(CitationConfig(dataset="cora"),
                              str(planetoid_root), device=CPU)
    monkeypatch.setattr(sys, "argv", [
        "citation", "--dataset", "cora", "--data_path", str(planetoid_root),
        "--sharded", "--trainer", "newton", "--device", "cpu"])
    port_citation.main()
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("Validation Accuracy: ")
    assert out[-1].startswith("Pre-compute time: 0.0000s")
    test_acc = float(out[-2].rsplit(" ", 1)[1])
    assert abs(test_acc - plain["test_accuracy"]) <= 0.05


@pytest.mark.parametrize("inductive", [True, False])
def test_reddit_sharded_matches_unsharded(reddit_root, inductive):
    """The sharded run against the unsharded one (itself held against the
    reference's in tests/test_torch_port_reddit.py): the same keys, the
    features to the bf16 rounding of the block-dense cells, the F1."""
    got = port_reddit.run(data_path=str(reddit_root), sharded=True,
                          inductive=inductive, device=CPU)
    plain = port_reddit.run(data_path=str(reddit_root), inductive=inductive,
                            device=CPU)
    assert set(got) == set(plain)
    assert abs(got["f1_micro"] - plain["f1_micro"]) < 1e-2
    a, b = got["eval_features"].numpy(), plain["eval_features"].numpy()
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-2


def test_reddit_sharded_formulation_rejections(reddit_root):
    with pytest.raises(ValueError, match="unknown formulation"):
        port_reddit.run(data_path=str(reddit_root), sharded=True,
                        formulation="dense", device=CPU)


def test_scaling_cli_json_contract(monkeypatch, capsys):
    """The reference's test_scaling_cli_json_contract, plus the rank
    counts and their placement label."""
    scaling.main(["--nodes", "2000", "--edges", "20000", "--features",
                  "16", "--repeats", "1", "--json", "--device", "cpu"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [2]
    for r in rows:
        assert r["plan_build_s"] >= 0.0
        cm = r["comm_model"]
        assert cm["ici_bytes_per_hop_halo"] >= 0
        assert cm["ici_bytes_per_hop_allgather"] > 0
        assert 0 < cm["projected_efficiency_halo"] <= 1.0
        assert "assumed_ici_gbps" in cm
        assert r["placement"] == f"{r['devices']} ranks on the CPU, gloo"


@pytest.mark.parametrize("world,want", [(1, [1]), (2, [2]), (4, [2, 4]),
                                        (6, [2, 4, 6])])
def test_scaling_rank_counts(world, want):
    assert scaling.rank_counts(world) == want


def test_dist_demo_matches_world_of_one(capsys):
    """The reference's multi-process test: 2 procs x 2 devices, the fit
    equal to the same fit in one process."""
    code = dist_demo.main(["--procs", "2", "--devices-per-proc", "2",
                           *DEMO])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and report["ok"] is True
    assert report["global_devices"] == 4
    # each rank is a process of its own here
    assert report["process_count_seen"] == 4
    assert report["max_loss_deviation_vs_single_process"] < 1e-4
    assert report["max_param_deviation_vs_single_process"] < 1e-4
    assert np.isfinite(report["final_loss"])


def test_dist_demo_problem_is_the_references():
    from sgc_tpu.cli.dist_demo import _build_problem as ref_problem

    got = dist_demo._build_problem(3, 300, 2000, 8, 4)
    want = ref_problem(3, 300, 2000, 8, 4)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    n = got[0].nnz
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got[0], k)[:n],
                                      np.asarray(getattr(want[0], k))[:n])


def test_dist_demo_tcp_workers(tmp_path):
    """``--worker`` ranks joined through a TCP rendezvous on localhost
    (``init_distributed``) run the fit as one world."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sgc_tpu_torch.cli.dist_demo", "--worker",
         "--procs", "2", "--devices-per-proc", "1", "--process-id", str(i),
         "--coordinator", f"127.0.0.1:{port}", *DEMO,
         *(["--out", str(tmp_path / "w.json")] if i == 0 else [])],
        env=env, cwd=REPO_ROOT) for i in range(2)]
    codes = [p.wait(timeout=300) for p in procs]
    assert codes == [0, 0]
    got = json.loads((tmp_path / "w.json").read_text())
    assert got["process_count"] == 2 and got["n_devices"] == 2
    assert len(got["losses"]) == 4 and np.isfinite(got["losses"]).all()


def test_dist_demo_worker_needs_one_device_per_process():
    with pytest.raises(ValueError, match="one device"):
        dist_demo.main(["--worker", "--procs", "2", "--devices-per-proc",
                        "2", "--coordinator", "127.0.0.1:1", *DEMO])
