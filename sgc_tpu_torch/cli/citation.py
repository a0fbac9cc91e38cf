"""Citation-network SGC/GCN training CLI (the counterpart of
sgc_tpu/cli/citation.py), on the card by default:

    python -m sgc_tpu_torch.cli.citation --dataset cora --tuned
    python -m sgc_tpu_torch.cli.citation --dataset citeseer --tuned --epochs 150
    python -m sgc_tpu_torch.cli.citation --propagator appnp --degree 16
    python -m sgc_tpu_torch.cli.citation --dataset pubmed --model GCN --tuned
    python -m sgc_tpu_torch.cli.citation --dataset cora --model GCNII

Load (``data/planetoid.py``); for SGC propagate ``S^K X`` once (``sgc``:
``sgc_precompute``; ``appnp`` / ``ssgc``: their propagators, timed the
same way), train the head with Adam on the train rows
(``train_regression``); for GCN train through the graph (``train_gcn``,
no precompute) and apply the model to the whole graph; likewise for
GCNII (``train_gcnii``), whose flags default to the authors' Cora
settings (github.com/chennnM/GCNII, ``train.py``: 64 layers of 64, alpha
0.1, lamda 0.5, lr 0.01, L2 0.01 on the conv weights and 5e-4 on the
dense layers, dropout 0.6; it has no tuned table and no sharded path).
Report val/test accuracy.

``--sharded`` trains over a world of ranks the CLI launches
(``parallel.distributed.cli_world``: one rank per card over NCCL, or with
``--device cpu`` the gloo ranks ``SGC_TPU_TORCH_CPU_RANKS`` names): SGC
through ``fit_sharded`` (``--trainer adam`` or ``newton``), GCN through
``fit_gcn_sharded``; the head is then evaluated, as in the reference, on
the single-device propagation. A propagator other than sgc raises the
reference's ``ValueError``.

    python -m sgc_tpu_torch.cli.citation --dataset cora --sharded
"""

from __future__ import annotations

import argparse
from time import perf_counter

import torch

from sgc_tpu_torch.data.planetoid import load_citation
from sgc_tpu_torch.models.gcnii import scaled_operator
from sgc_tpu_torch.models.registry import get_model
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.propagate import fetch_propagator, sgc_precompute
from sgc_tpu_torch.train.loops import (train_gcn, train_gcnii,
                                       train_regression)
from sgc_tpu_torch.train.metrics import accuracy
from sgc_tpu_torch.utils.config import CitationConfig
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync
from sgc_tpu_torch.utils.seeding import set_seed

# seconds a sharded world may take before every rank is stopped
SHARDED_TIMEOUT_S = 3600.0

# GCNII's defaults (the authors' Cora settings): those of the shared
# flags, where not given, and those of its own
GCNII_FLAGS = {"lr": 0.01, "weight_decay": 0.01, "hidden": 64,
               "dropout": 0.6}
GCNII_DEFAULTS = {"layers": 64, "alpha": 0.1, "lamda": 0.5,
                  "wd_dense": 5e-4}


def run(cfg: CitationConfig, data_path: str | None = None,
        propagator: str = "sgc", sharded: bool = False,
        trainer: str = "adam", device=None,
        gcnii: dict | None = None) -> dict:
    """One citation run; ``device=None`` means the card (raises without
    one). ``trainer`` picks the sharded SGC head's trainer and is unused
    without ``sharded``, as in the reference. ``gcnii`` overrides
    :data:`GCNII_DEFAULTS` (``layers``, ``alpha``, ``lamda``,
    ``wd_dense``) for ``cfg.model == "GCNII"``, whose ``weight_decay`` is
    the conv weights' L2."""
    if sharded and propagator != "sgc":
        raise ValueError("--sharded supports the sgc propagator only")
    if cfg.model == "GCNII" and (sharded or cfg.tuned):
        raise ValueError("GCNII has no sharded path and no tuned table")
    dev = resolve_device(device)
    cfg = cfg.resolve()
    init_fn, apply_fn = get_model(cfg.model)
    generator = set_seed(cfg.seed)
    data = load_citation(cfg.dataset, cfg.normalization, data_path,
                         device=dev)
    if sharded:
        return _run_sharded(cfg, data, dev, trainer)
    if cfg.model == "GCN":
        return _run_gcn(cfg, data, init_fn, apply_fn, generator, dev)
    if cfg.model == "GCNII":
        return _run_gcnii(cfg, data, init_fn, apply_fn, generator, dev,
                          {**GCNII_DEFAULTS, **(gcnii or {})})

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


def _run_gcnii(cfg, data, init_fn, apply_fn, generator, dev,
               opts: dict) -> dict:
    """GCNII: as GCN, no precompute; the model is applied to the whole
    graph through the prescaled operator."""
    alpha, lamda = opts["alpha"], opts["lamda"]
    model = init_fn(generator, data.features.shape[1], cfg.hidden or 64,
                    data.n_classes, opts["layers"], device=dev)
    model, train_time = train_gcnii(
        model, data.features, data.graph, data.idx_train,
        data.labels[data.idx_train], epochs=cfg.epochs, lr=cfg.lr,
        wd_conv=cfg.weight_decay, wd_dense=opts["wd_dense"], alpha=alpha,
        lamda=lamda, dropout=cfg.dropout, seed=cfg.seed)
    with torch.no_grad():
        logits = apply_fn(model, data.features,
                          scaled_operator(data.graph, alpha), alpha, lamda)
    return _result(data, logits[data.idx_val], logits[data.idx_test], 0.0,
                   train_time)


def _run_sharded(cfg, data, dev, trainer: str) -> dict:
    """Citation training over the world ``cli_world(dev)`` starts; the
    reference's keys, with ``formulation`` and ``halo_fraction`` (SGC) or
    ``final_loss`` (GCN)."""
    import tempfile
    from types import SimpleNamespace

    from sgc_tpu_torch.graph.sparse import host
    from sgc_tpu_torch.models.gcn import gcn_apply, params_from_jax
    from sgc_tpu_torch.models.sgc import SGC
    from sgc_tpu_torch.ops.propagate import propagate
    from sgc_tpu_torch.parallel import bodies
    from sgc_tpu_torch.parallel.distributed import cli_world, launch

    ranks, backend, rank_dev = cli_world(dev)
    t0 = perf_counter()
    with tempfile.TemporaryDirectory(prefix="sgc_citation_") as root:
        bodies.write_inputs(root, data.graph, host(data.features),
                            host(data.labels), data.idx_train)
        common = {"epochs": cfg.epochs, "lr": cfg.lr,
                  "weight_decay": cfg.weight_decay, "seed": cfg.seed}
        if cfg.model == "SGC":
            body, kw = bodies.cli_sgc, {**common, "degree": cfg.degree,
                                        "trainer": trainer}
        else:
            body, kw = bodies.cli_gcn, {**common,
                                        "n_hidden": cfg.hidden or 16}
        out = launch(body, ranks, backend, f"{root}/init",
                     (root, {"n_classes": data.n_classes, "kw": kw,
                             "device": rank_dev}), SHARDED_TIMEOUT_S)[0]
    if cfg.model == "SGC":
        # the single-device propagation evaluates the head (params are
        # node-order independent; W cut back to the unpadded width)
        feats = propagate(data.features, data.graph, cfg.degree)
        n_feat = data.features.shape[1]
        head = SGC(torch.as_tensor(out["w"][:n_feat], device=dev),
                   torch.as_tensor(out["b"], device=dev))
        with torch.no_grad():
            logits_val = head(feats[data.idx_val])
            logits_test = head(feats[data.idx_test])
        extra = {"formulation": out["report"]["formulation"],
                 "halo_fraction": out["report"]["halo_fraction"]}
    else:
        model = params_from_jax(SimpleNamespace(**out["params"]),
                                device=dev)
        with torch.no_grad():
            logits = gcn_apply(model, data.features, data.graph)
        logits_val, logits_test = logits[data.idx_val], logits[
            data.idx_test]
        extra = {"final_loss": out["losses"][-1]}
    total = perf_counter() - t0
    return {**_result(data, logits_val, logits_test, 0.0, total), **extra}


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
    parser.add_argument("--lr", type=float, default=None,
                        help="default 0.2; GCNII 0.01")
    parser.add_argument("--weight_decay", type=float, default=None,
                        help="default 5e-6; GCNII 0.01 (its conv weights)")
    parser.add_argument("--hidden", type=int, default=None,
                        help="default 16 for GCN; GCNII 64")
    parser.add_argument("--dropout", type=float, default=None,
                        help="default 0.0; GCNII 0.6")
    parser.add_argument("--model", default="SGC",
                        choices=["SGC", "GCN", "GCNII"])
    parser.add_argument("--layers", type=int,
                        default=GCNII_DEFAULTS["layers"],
                        help="GCNII: number of GCNII layers")
    parser.add_argument("--alpha", type=float,
                        default=GCNII_DEFAULTS["alpha"],
                        help="GCNII: initial residual share")
    parser.add_argument("--lamda", type=float,
                        default=GCNII_DEFAULTS["lamda"],
                        help="GCNII: identity mapping's lambda")
    parser.add_argument("--wd_dense", type=float,
                        default=GCNII_DEFAULTS["wd_dense"],
                        help="GCNII: L2 on the two dense layers")
    parser.add_argument("--propagator", default="sgc",
                        choices=["sgc", "appnp", "ssgc"],
                        help="propagation scheme for the SGC path")
    parser.add_argument("--normalization", default="AugNormAdj")
    parser.add_argument("--sharded", action="store_true",
                        help="train over a world of ranks (fit_sharded / "
                             "fit_gcn_sharded)")
    parser.add_argument("--trainer", default="adam",
                        choices=["adam", "newton"],
                        help="--sharded SGC head trainer: adam epochs or "
                             "the newton fit (unused without --sharded)")
    parser.add_argument("--degree", type=int, default=2)
    parser.add_argument("--tuned", action="store_true")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()

    shared = {**(GCNII_FLAGS if args.model == "GCNII" else {}),
              **{k: getattr(args, k) for k in GCNII_FLAGS
                 if getattr(args, k) is not None}}
    cfg = CitationConfig(
        dataset=args.dataset, seed=args.seed, epochs=args.epochs,
        model=args.model, normalization=args.normalization,
        degree=args.degree, tuned=args.tuned, **shared)
    if cfg.tuned:
        cfg.resolve()
        print(f"using tuned weight decay: {cfg.weight_decay}")
    res = run(cfg, args.data_path, propagator=args.propagator,
              sharded=args.sharded, trainer=args.trainer,
              device=args.device,
              gcnii={k: getattr(args, k) for k in GCNII_DEFAULTS})
    print("Validation Accuracy: {:.4f} Test Accuracy: {:.4f}".format(
        res["val_accuracy"], res["test_accuracy"]))
    print("Pre-compute time: {:.4f}s, train time: {:.4f}s, total: "
          "{:.4f}s".format(res["precompute_time"], res["train_time"],
                           res["total_time"]))


if __name__ == "__main__":
    main()
