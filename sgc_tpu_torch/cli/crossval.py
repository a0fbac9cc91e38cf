"""K-fold cross-validated TextSGC training with aggregate metrics (the
counterpart of sgc_tpu/cli/crossval.py), on the card by default:

    python -m sgc_tpu_torch.cli.crossval --dataset covid_19_production \
        --folds 5

Per fold: load the fold's ids, the structural-feature precompute, the
LBFGS head fit, and the prediction || label vector saved to
``<results_dir>/<ds>.<fold>.SGC.results.txt``; then the mean and std of
accuracy, weighted F1 and the Optimized-Precision score over the folds.
``per_fold_tuned`` maps a fold to its own weight decay (the per-fold
tuning of ``cli.tuning --family text --fold K``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from sgc_tpu_torch.cli.textsgc import run as run_textsgc
from sgc_tpu_torch.train.metrics import f1_weighted, optimized_precision
from sgc_tpu_torch.utils.config import TextConfig


def run_crossval(
    dataset: str,
    folds: int = 5,
    subset: str = "BCD",
    epochs: int = 3,
    weight_decay: float | None = None,
    tuned: bool = False,
    degree: int = 2,
    seed: int = 42,
    data_path: str | None = None,
    results_dir: str | None = "results",
    class_weights: bool = False,
    per_fold_tuned: dict | None = None,
    device=None,
) -> dict:
    fold_results = []
    for fold in range(folds):
        wd = weight_decay or 0.0
        if per_fold_tuned and fold in per_fold_tuned:
            wd = per_fold_tuned[fold]
        cfg = TextConfig(
            dataset=dataset, seed=seed, epochs=epochs,
            weight_decay=wd, degree=degree, tuned=tuned and not per_fold_tuned,
        )
        res = run_textsgc(
            cfg, subset=subset, data_path=data_path, fold=fold,
            class_weights=class_weights, device=device,
        )
        preds = np.asarray(res["predictions"])
        labels = np.asarray(res["test_labels"])
        if results_dir:
            out = Path(results_dir)
            out.mkdir(parents=True, exist_ok=True)
            np.savetxt(
                out / f"{dataset}.{fold}.SGC.results.txt",
                np.concatenate([preds, labels])[:, None],
                fmt="%d",
            )
        fold_results.append(
            {
                "fold": fold,
                "accuracy": res["test_accuracy"],
                "f1_weighted": f1_weighted(preds, labels),
                "op_score": optimized_precision(preds, labels),
                "total_time": res["total_time"],
            }
        )
        print(
            f"fold {fold}: acc {fold_results[-1]['accuracy']:.4f} "
            f"wF1 {fold_results[-1]['f1_weighted']:.4f} "
            f"OP {fold_results[-1]['op_score']:.4f}"
        )

    def agg(key):
        vals = [r[key] for r in fold_results]
        return float(np.mean(vals)), float(np.std(vals))

    summary = {
        "folds": fold_results,
        "accuracy_mean": agg("accuracy")[0],
        "accuracy_std": agg("accuracy")[1],
        "f1_weighted_mean": agg("f1_weighted")[0],
        "f1_weighted_std": agg("f1_weighted")[1],
        "op_mean": agg("op_score")[0],
        "op_std": agg("op_score")[1],
    }
    return summary


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--folds", type=int, default=5)
    parser.add_argument("--subset", default="BCD")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--weight_decay", type=float, default=None)
    parser.add_argument("--tuned", action="store_true")
    parser.add_argument("--degree", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--results_dir", default="results")
    parser.add_argument("--class_weights", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()

    summary = run_crossval(
        args.dataset, args.folds, args.subset, args.epochs,
        args.weight_decay, args.tuned, args.degree, args.seed,
        args.data_path, args.results_dir, args.class_weights,
        device=args.device,
    )
    print(
        "CV accuracy: {:.4f} ± {:.4f}  weighted-F1: {:.4f} ± {:.4f}  "
        "OP: {:.4f} ± {:.4f}".format(
            summary["accuracy_mean"], summary["accuracy_std"],
            summary["f1_weighted_mean"], summary["f1_weighted_std"],
            summary["op_mean"], summary["op_std"],
        )
    )


if __name__ == "__main__":
    main()
