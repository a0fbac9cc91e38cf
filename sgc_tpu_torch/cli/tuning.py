"""Weight-decay tuning CLI (the counterpart of sgc_tpu/cli/tuning.py),
on the card by default:

    python -m sgc_tpu_torch.cli.tuning --dataset cora
    python -m sgc_tpu_torch.cli.tuning --dataset pubmed --grid 16
    python -m sgc_tpu_torch.cli.tuning --family text --dataset ohsumed \
        [--fold K]

The propagation runs once. Citation family: the K hops for the train and
val rows only, then each of the 60 TPE trials is an Adam fit of the head
(``train_regression``, from one init) scored on validation accuracy;
``--grid N`` trains N log-spaced weight decays at once
(``train_regression_many``) and scores every head in one batched matmul.
Text family: the structural features (``text_structural_features``),
then each TPE trial over ``loguniform(1e-6, 1)`` is an LBFGS fit
(``train_linear``, from one init); ``--fold K`` tunes one
cross-validation fold. The best weight decay and its val accuracy go to
``<output>/<dataset>.json`` (``<dataset>.<K>.json`` for a fold).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from sgc_tpu_torch.data.planetoid import load_citation
from sgc_tpu_torch.data.textcorpus import load_corpus
from sgc_tpu_torch.models.sgc import init_sgc, sgc_apply
from sgc_tpu_torch.ops.propagate import (
    sgc_precompute,
    text_structural_features,
)
from sgc_tpu_torch.train.loops import (
    eval_linear,
    train_linear,
    train_regression,
    train_regression_many,
)
from sgc_tpu_torch.train.metrics import accuracy
from sgc_tpu_torch.tune.tpe import fmin, loguniform
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.seeding import set_seed


def grid_accuracies(heads, val_x: torch.Tensor,
                    val_y: torch.Tensor) -> np.ndarray:
    """Val accuracy of each head, float32 ``[len(heads)]``: every head's
    logits in one batched matmul, each accuracy the hit count times
    f32(1/n) (the reference's bits, train/metrics.py::hit_rate)."""
    logits = torch.matmul(val_x, torch.stack([h.w for h in heads]))
    if heads[0].b is not None:
        logits = logits + torch.stack([h.b for h in heads])[:, None, :]
    hits = (logits.argmax(dim=-1) == val_y[None, :]).sum(dim=1).float()
    inv_n = torch.tensor(1.0 / max(int(val_y.shape[0]), 1),
                         dtype=torch.float32, device=hits.device)
    return (hits * inv_n).cpu().numpy()


def tune_citation(dataset, degree, epochs, lr, max_evals, seed, data_path,
                  grid: int = 0, device=None):
    """TPE over ``loguniform(1e-10, 1e-4)`` (the default) or, with
    ``grid=N``, N log-spaced weight decays in one batched fit. Returns
    ``({"weight_decay": best}, val accuracy)`` (tuning.py:31-96)."""
    dev = resolve_device(device)
    generator = set_seed(seed)
    data = load_citation(dataset, "AugNormAdj", data_path, device=dev)
    # tuning reads the train and val rows only: propagate just those
    idx_tv = np.concatenate([np.asarray(data.idx_train),
                             np.asarray(data.idx_val)])
    features, _ = sgc_precompute(data.features, data.graph, degree,
                                 out_rows=idx_tv)
    n_tr = len(data.idx_train)
    train_x, val_x = features[:n_tr], features[n_tr:]
    train_y = data.labels[data.idx_train]
    val_y = data.labels[data.idx_val]
    # one init for every trial and candidate (the trainers copy it)
    model0 = init_sgc(generator, features.shape[1], data.n_classes,
                      device=dev)

    if grid:
        if grid < 2:
            raise ValueError(
                f"--grid {grid}: need >= 2 log-spaced candidates to span "
                "the search space (use TPE for single-point evaluation)")
        wds = np.logspace(-10, -4, grid)
        heads, _, _ = train_regression_many(model0, train_x, train_y, wds,
                                            epochs=epochs, lr=lr)
        accs = grid_accuracies(heads, val_x, val_y)
        i_best = int(np.argmax(accs))
        return {"weight_decay": float(wds[i_best])}, float(accs[i_best])

    def objective(params):
        model, _ = train_regression(model0, train_x, train_y, epochs,
                                    params["weight_decay"], lr)
        return -accuracy(sgc_apply(model, val_x), val_y)

    best, loss = fmin(objective,
                      {"weight_decay": loguniform(1e-10, 1e-4)},
                      max_evals=max_evals, seed=seed)
    return best, -loss


def tune_text(dataset, degree, epochs, max_evals, seed, data_path, subset,
              fold=None, device=None):
    """TPE over ``loguniform(1e-6, 1)``, each trial an LBFGS fit of the
    text head (no bias, xavier-normal, one init for every trial) scored
    on val accuracy; ``fold`` selects a cross-validation fold. Returns
    ``({"weight_decay": best}, val accuracy)`` (tuning.py:99-133)."""
    dev = resolve_device(device)
    generator = set_seed(seed)
    data = load_corpus(dataset, subset, data_path, fold=fold, device=dev)
    binary = dataset == "mr"
    feat_dict, _ = text_structural_features(data.graph, data.index_dict,
                                            degree=degree)
    label_dict = {k: torch.as_tensor(v, device=dev)
                  for k, v in data.label_dict.items()}
    nclass = 1 if binary else data.n_classes
    model0 = init_sgc(generator, feat_dict["train"].shape[1], nclass,
                      bias=False, init="xavier_normal", device=dev)

    def objective(params):
        model, _ = train_linear(model0, feat_dict["train"],
                                label_dict["train"],
                                weight_decay=params["weight_decay"],
                                epochs=epochs, binary=binary)
        res = eval_linear(model, feat_dict["val"], label_dict["val"],
                          binary)
        return -res["accuracy"]

    best, loss = fmin(objective, {"weight_decay": loguniform(1e-6, 1.0)},
                      max_evals=max_evals, seed=seed)
    return best, -loss


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--family", default="citation",
                        choices=["citation", "text"])
    parser.add_argument("--dataset", default="cora")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--degree", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--lr", type=float, default=0.2)
    parser.add_argument("--max_evals", type=int, default=60)
    parser.add_argument("--grid", type=int, default=0,
                        help="grid search over N log-spaced weight decays "
                        "(one batched fit) instead of sequential TPE")
    parser.add_argument("--subset", default="BCD")
    parser.add_argument("--fold", type=int, default=None,
                        help="cross-validation fold (text family)")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--output", default="tuned")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()

    if args.family == "citation":
        best, val_acc = tune_citation(
            args.dataset, args.degree, args.epochs or 100, args.lr,
            args.max_evals, args.seed, args.data_path, grid=args.grid,
            device=args.device)
    else:
        if args.grid:
            raise SystemExit(
                "--grid is citation-family only (the text family's LBFGS "
                "fit is not batched); use TPE (--max_evals) instead")
        best, val_acc = tune_text(
            args.dataset, args.degree, args.epochs or 3, args.max_evals,
            args.seed, args.data_path, args.subset, fold=args.fold,
            device=args.device)

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = (args.dataset if args.fold is None
            else f"{args.dataset}.{args.fold}")
    out_path = out_dir / f"{stem}.json"
    with open(out_path, "w") as f:
        json.dump({"weight_decay": best["weight_decay"],
                   "val_accuracy": val_acc}, f)
    print(f"best weight_decay: {best['weight_decay']:.6e} "
          f"(val acc {val_acc:.4f}) -> {out_path}")


if __name__ == "__main__":
    main()
