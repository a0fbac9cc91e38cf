"""Citation-network SGC/GCN training CLI (the counterpart of
sgc_tpu/cli/citation.py), on the card by default:

    python -m sgc_tpu_torch.cli.citation --dataset cora --tuned
    python -m sgc_tpu_torch.cli.citation --dataset citeseer --tuned --epochs 150
    python -m sgc_tpu_torch.cli.citation --propagator appnp --degree 16
    python -m sgc_tpu_torch.cli.citation --dataset pubmed --model GCN --tuned

Load (``data/planetoid.py``); for SGC propagate ``S^K X`` once (``sgc``:
``sgc_precompute``; ``appnp`` / ``ssgc``: their propagators, timed the
same way), train the head with Adam on the train rows
(``train_regression``); for GCN train through the graph (``train_gcn``,
no precompute) and apply the model to the whole graph. Report val/test
accuracy. ``--sharded`` is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
from time import perf_counter

import torch

from sgc_tpu_torch.data.planetoid import load_citation
from sgc_tpu_torch.models.registry import get_model
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.propagate import fetch_propagator, sgc_precompute
from sgc_tpu_torch.train.loops import train_gcn, train_regression
from sgc_tpu_torch.train.metrics import accuracy
from sgc_tpu_torch.utils.config import CitationConfig
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync
from sgc_tpu_torch.utils.seeding import set_seed

SHARDED_TODO = "ROADMAP queue 1 item 8 (distribution)"


def run(cfg: CitationConfig, data_path: str | None = None,
        propagator: str = "sgc", sharded: bool = False,
        trainer: str = "adam", device=None) -> dict:
    """One citation run; ``device=None`` means the card (raises without
    one). ``trainer`` picks the sharded path's head trainer in the
    reference and is unused here, as there without ``sharded``."""
    if sharded:
        raise NotImplementedError(f"--sharded is not ported yet: "
                                  f"{SHARDED_TODO}")
    dev = resolve_device(device)
    cfg = cfg.resolve()
    init_fn, apply_fn = get_model(cfg.model)
    generator = set_seed(cfg.seed)
    data = load_citation(cfg.dataset, cfg.normalization, data_path,
                         device=dev)
    if cfg.model == "GCN":
        return _run_gcn(cfg, data, init_fn, apply_fn, generator, dev)

    model = init_fn(generator, data.features.shape[1], data.n_classes,
                    device=dev)
    if propagator == "sgc":
        features, precompute_time = sgc_precompute(data.features,
                                                   data.graph, cfg.degree)
    else:
        prop = fetch_propagator(propagator)
        kernels.load_all(dev)
        t0 = perf_counter()
        features = prop(data.features, data.graph, cfg.degree)
        sync(dev)
        precompute_time = perf_counter() - t0
    model, train_time = train_regression(
        model, features[data.idx_train], data.labels[data.idx_train],
        cfg.epochs, cfg.weight_decay, cfg.lr)
    logits_val = apply_fn(model, features[data.idx_val])
    logits_test = apply_fn(model, features[data.idx_test])
    return _result(data, logits_val, logits_test, precompute_time,
                   train_time)


def _run_gcn(cfg, data, init_fn, apply_fn, generator, dev) -> dict:
    """GCN: the propagation runs inside the model, so there is no
    precompute (``precompute_time`` 0.0, as in the reference)."""
    model = init_fn(generator, data.features.shape[1], cfg.hidden or 16,
                    data.n_classes, device=dev)
    model, train_time = train_gcn(
        model, data.features, data.graph, data.idx_train,
        data.labels[data.idx_train], epochs=cfg.epochs,
        weight_decay=cfg.weight_decay, lr=cfg.lr, dropout=cfg.dropout,
        seed=cfg.seed)
    with torch.no_grad():
        logits = apply_fn(model, data.features, data.graph)
    return _result(data, logits[data.idx_val], logits[data.idx_test], 0.0,
                   train_time)


def _result(data, logits_val, logits_test, precompute_time,
            train_time) -> dict:
    return {
        "val_accuracy": accuracy(logits_val, data.labels[data.idx_val]),
        "test_accuracy": accuracy(logits_test, data.labels[data.idx_test]),
        "precompute_time": precompute_time,
        "train_time": train_time,
        "total_time": precompute_time + train_time,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", default="cora")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.2)
    parser.add_argument("--weight_decay", type=float, default=5e-6)
    parser.add_argument("--hidden", type=int, default=0)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--model", default="SGC", choices=["SGC", "GCN"])
    parser.add_argument("--propagator", default="sgc",
                        choices=["sgc", "appnp", "ssgc"],
                        help="propagation scheme for the SGC path")
    parser.add_argument("--normalization", default="AugNormAdj")
    parser.add_argument("--sharded", action="store_true",
                        help="multi-device training (not ported yet: "
                             "raises)")
    parser.add_argument("--trainer", default="adam",
                        choices=["adam", "newton"],
                        help="--sharded head trainer (unused without it)")
    parser.add_argument("--degree", type=int, default=2)
    parser.add_argument("--tuned", action="store_true")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()

    cfg = CitationConfig(
        dataset=args.dataset, seed=args.seed, epochs=args.epochs,
        lr=args.lr, weight_decay=args.weight_decay, hidden=args.hidden,
        dropout=args.dropout, model=args.model,
        normalization=args.normalization, degree=args.degree,
        tuned=args.tuned)
    if cfg.tuned:
        cfg.resolve()
        print(f"using tuned weight decay: {cfg.weight_decay}")
    res = run(cfg, args.data_path, propagator=args.propagator,
              sharded=args.sharded, trainer=args.trainer,
              device=args.device)
    print("Validation Accuracy: {:.4f} Test Accuracy: {:.4f}".format(
        res["val_accuracy"], res["test_accuracy"]))
    print("Pre-compute time: {:.4f}s, train time: {:.4f}s, total: "
          "{:.4f}s".format(res["precompute_time"], res["train_time"],
                           res["total_time"]))


if __name__ == "__main__":
    main()
