"""The port's boundaries: it never imports JAX or the reference package,
its entry points default to the CUDA card and raise without one, and
``chip_smoke.py`` refuses to report without a card or outside a
checkout."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_reference():
    code = """
import importlib.util, pkgutil, sys
import sgc_tpu_torch
walked = list(pkgutil.walk_packages(sgc_tpu_torch.__path__,
                                    "sgc_tpu_torch."))
for m in walked:
    __import__(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "sgc_tpu"
             or n.startswith("sgc_tpu."))
print(",".join(bad))
print(sum(1 for n in sys.modules if n.startswith("sgc_tpu_torch.")))
print(len(walked))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert out[0] == "", f"port imported {out[0]}"
    # every module, the slices' new ones included, really was imported
    assert int(out[1]) >= int(out[2]) >= 40


PORT_ENTRY_MODULES = ("sgc_tpu_torch/bench.py",
                      "sgc_tpu_torch/examples/quickstart.py")


@pytest.mark.parametrize("path", PORT_ENTRY_MODULES)
def test_entry_module_imports_neither_jax_nor_reference(path):
    """The bench and the quickstart name no JAX or reference import in
    their source, and importing either loads none."""
    imports = re.compile(r"^\s*(import|from)\s+(jax|sgc_tpu)\b(?!_torch)",
                         re.M)
    assert imports.findall((REPO / path).read_text()) == []
    mod = path[:-3].replace("/", ".")
    code = f"""
import sys
import {mod}
print(",".join(sorted(n for n in sys.modules
                      if n.split(".")[0] in ("jax", "sgc_tpu"))))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "", f"{mod} imported {out}"


def test_bench_swallows_no_failure():
    """``sgc_tpu_torch/bench.py`` has no bare ``except``, no ``except
    Exception`` / ``BaseException`` and no handler that only logs or
    passes: a failure ends the run."""
    import ast

    tree = ast.parse((REPO / "sgc_tpu_torch/bench.py").read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    broad = [h.lineno for h in handlers
             if h.type is None or (isinstance(h.type, ast.Name)
                                   and h.type.id in ("Exception",
                                                     "BaseException"))]
    assert broad == [], f"broad except at lines {broad}"
    swallowing = [h.lineno for h in handlers
                  if not any(isinstance(n, ast.Raise) for n in ast.walk(h))]
    assert swallowing == [], f"handlers that do not re-raise: {swallowing}"


def test_port_imports_no_sklearn():
    """The card's machine has no scikit-learn: no module of the port
    imports it, and importing all of them loads none of it."""
    imports = re.compile(r"^\s*(import|from)\s+sklearn\b", re.M)
    hits = [str(p.relative_to(REPO)) for p in
            sorted((REPO / "sgc_tpu_torch").rglob("*.py")) + [
                REPO / "chip_smoke.py"]
            if imports.search(p.read_text())]
    assert hits == [], hits
    code = """
import pkgutil, sys
import sgc_tpu_torch
for m in pkgutil.walk_packages(sgc_tpu_torch.__path__, "sgc_tpu_torch."):
    __import__(m.name)
print(",".join(sorted(n for n in sys.modules if n.split(".")[0] in
                      ("sklearn", "jax", "sgc_tpu"))))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "", f"port imported {out}"


def _entry_points():
    from sgc_tpu_torch.cli import citation, crossval, reddit, sweep, tuning
    from sgc_tpu_torch.cli import pallas_bench, sequence, serve, textsgc
    from sgc_tpu_torch.cli import word2vec as w2v_cli
    from sgc_tpu_torch.data.textcorpus import load_corpus
    from sgc_tpu_torch.data.planetoid import load_citation
    from sgc_tpu_torch.data.reddit import load_reddit
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.graph.sparse import SparseGraph
    from sgc_tpu_torch.models import deep_gcn, gat, gcn
    from sgc_tpu_torch.models.sgc import init_sgc, params_from_jax
    from sgc_tpu_torch.ops.calibrate import measured_rates
    from sgc_tpu_torch.ops.capability import require_cuda_kernels
    from sgc_tpu_torch.serve import InferenceEngine
    from sgc_tpu_torch.utils.checkpoint import load_params
    from sgc_tpu_torch.utils.device import resolve_device
    from sgc_tpu_torch.models import transformer
    from sgc_tpu_torch.textgraph.embedding import EmbedderConfig, WordEmbedder
    from sgc_tpu_torch.textgraph.word2vec import Word2Vec
    from sgc_tpu_torch.train.finetune import finetune_pretrained
    from sgc_tpu_torch.train.sequence import train_sequence_classifier
    from sgc_tpu_torch import bench
    from sgc_tpu_torch.examples import quickstart

    g = SparseGraph.from_coo(np.array([0, 1]), np.array([1, 0]),
                             np.ones(2, np.float32), 2, 2)
    feats = np.zeros((2, 3), np.float32)
    tcfg = transformer.TransformerConfig(8, 2, max_len=4, dim=8, n_heads=2,
                                         n_layers=1)
    return {
        "resolve_device": lambda: resolve_device(None),
        "SparseGraph.to": lambda: g.to(),
        "init_sgc": lambda: init_sgc(torch.Generator(), 3, 2),
        "params_from_jax": lambda: params_from_jax(np.zeros((3, 2)), None),
        "LocalityPlan.build": lambda: LocalityPlan.build(
            g, feats, np.zeros(2, np.int32), np.arange(2)),
        "LocalityPlan.build onehot": lambda: LocalityPlan.build(
            g, feats, np.zeros(2, np.int32), np.arange(2),
            formulation="onehot"),
        "LocalityPlan.build rcm": lambda: LocalityPlan.build(
            g, feats, np.zeros(2, np.int32), np.arange(2), ordering="rcm"),
        "cli.pallas_bench.run": lambda: pallas_bench.run(
            pallas_bench.parser().parse_args([])),
        "measured_rates": lambda: measured_rates(),
        "require_cuda_kernels": lambda: require_cuda_kernels(),
        "init_sgc xavier_normal": lambda: init_sgc(
            torch.Generator(), 3, 2, init="xavier_normal"),
        "load_citation": lambda: load_citation("cora", data_path="."),
        "load_reddit": lambda: load_reddit(data_path="."),
        "cli.citation.run": lambda: citation.run(citation.CitationConfig(),
                                                 "."),
        "cli.reddit.run": lambda: reddit.run(data_path="."),
        "cli.sweep.sweep": lambda: sweep.sweep(["cora"], [1],
                                               data_path="."),
        "init_gcn": lambda: gcn.init_gcn(torch.Generator(), 3, 4, 2),
        "init_gat_layer": lambda: gat.init_gat_layer(torch.Generator(), 3,
                                                     4),
        "init_multi_head": lambda: gat.init_multi_head(torch.Generator(), 2,
                                                       3, 4),
        "init_deep_gcn": lambda: deep_gcn.init_deep_gcn(
            torch.Generator(), 3, 4, 2, n_layers=3),
        "cli.tuning.tune_citation": lambda: tuning.tune_citation(
            "cora", 2, 10, 0.2, 1, 42, "."),
        "load_corpus": lambda: load_corpus("covid", data_path="."),
        "cli.textsgc.run": lambda: textsgc.run(textsgc.TextConfig(), "BCD",
                                               "."),
        "cli.crossval.run_crossval": lambda: crossval.run_crossval(
            "covid", data_path="."),
        "cli.tuning.tune_text": lambda: tuning.tune_text(
            "covid", 2, 3, 1, 42, ".", "BCD"),
        "InferenceEngine": lambda: InferenceEngine(
            init_sgc(torch.Generator(), 3, 2, device="cpu"), features=feats),
        "InferenceEngine inductive": lambda: InferenceEngine(
            init_sgc(torch.Generator(), 3, 2, device="cpu"), graph=g,
            raw_features=feats),
        "load_params": lambda: load_params("model.npz"),
        "cli.serve.run_bench": lambda: serve.run_bench(serve.parser(
            ).parse_args(["--bench"])),
        "init_transformer": lambda: transformer.init_transformer(
            tcfg, torch.Generator()),
        "train_sequence_classifier": lambda: train_sequence_classifier(
            [["a"]], np.zeros(1), tcfg),
        "cli.sequence.run": lambda: sequence.run(sequence.parser(
            ).parse_args(["--metadata", "m.txt", "--corpus", "c.txt"])),
        "Word2Vec.train": lambda: Word2Vec().train([["a", "b"]]),
        "cli.word2vec.run": lambda: w2v_cli.run(w2v_cli.parser(
            ).parse_args(["--corpus", "c.txt", "--out", "w2v"])),
        "WordEmbedder torch": lambda: WordEmbedder(EmbedderConfig(
            backend="torch")).embed_words(["a"]),
        "finetune_pretrained": lambda: finetune_pretrained(
            ["a"], np.zeros(1), 2),
        "bench.main": lambda: bench.main([]),
        "examples.quickstart.main": lambda: quickstart.main([]),
    }


@pytest.mark.parametrize("name", [
    "resolve_device", "SparseGraph.to", "init_sgc", "params_from_jax",
    "LocalityPlan.build", "LocalityPlan.build onehot", "measured_rates",
    "require_cuda_kernels", "init_sgc xavier_normal", "load_citation",
    "load_reddit", "cli.citation.run", "cli.reddit.run", "cli.sweep.sweep",
    "init_gcn", "init_gat_layer", "init_multi_head", "init_deep_gcn",
    "cli.tuning.tune_citation", "load_corpus", "cli.textsgc.run",
    "cli.crossval.run_crossval", "cli.tuning.tune_text", "InferenceEngine",
    "InferenceEngine inductive", "load_params", "cli.serve.run_bench",
    "init_transformer", "train_sequence_classifier", "cli.sequence.run",
    "Word2Vec.train", "cli.word2vec.run", "WordEmbedder torch",
    "finetune_pretrained", "LocalityPlan.build rcm",
    "cli.pallas_bench.run", "bench.main", "examples.quickstart.main"])
def test_default_device_raises_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_cpu_is_used_only_when_asked():
    from sgc_tpu_torch.models.sgc import init_sgc
    from sgc_tpu_torch.ops.calibrate import measured_rates

    m = init_sgc(torch.Generator().manual_seed(0), 4, 3, device="cpu")
    assert m.w.device.type == "cpu" and m.b.shape == (3,)
    assert measured_rates("cpu")["probed"] is False
    with pytest.raises(RuntimeError, match="CUDA"):
        from sgc_tpu_torch.ops.capability import require_cuda_kernels

        require_cuda_kernels("cpu")


def test_chip_smoke_fails_without_card_and_outside_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
