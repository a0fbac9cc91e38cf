"""TextSGC training CLI, doc-word graph text classification (the
counterpart of sgc_tpu/cli/textsgc.py), on the card by default:

    python -m sgc_tpu_torch.cli.textsgc --dataset ohsumed --tuned
    python -m sgc_tpu_torch.cli.textsgc --dataset covid --impl blockdense

Pipeline: load the doc-word graph and the per-phase doc ids, compute the
structural features (rows of S^2 at each phase's doc nodes, min-max
scaled on train; ``ops/propagate.py::text_structural_features``) without
an N x N densification unless ``--impl dense`` (or ``auto`` on a small
graph) asks for it, then fit the linear head (no bias, xavier-normal
init) with LBFGS and manual L2, or with ``--trainer newton``. ``mr`` is
binary (sigmoid + BCE).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from sgc_tpu_torch.data.textcorpus import load_corpus
from sgc_tpu_torch.models.sgc import init_sgc
from sgc_tpu_torch.ops.propagate import (
    TEXT_IMPLS,
    text_impl,
    text_structural_features,
)
from sgc_tpu_torch.train.loops import eval_linear, train_linear
from sgc_tpu_torch.utils.checkpoint import (
    _npz_path,
    load_features,
    save_features,
)
from sgc_tpu_torch.utils.config import TextConfig
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.seeding import set_seed


def run(cfg: TextConfig, subset: str = "BCD", data_path: str | None = None,
        fold: int | None = None, class_weights: bool = False,
        feat_cache: str | None = None, impl: str = "auto",
        trainer: str = "lbfgs", device=None) -> dict:
    """Train and score one TextSGC head. The result holds the three
    accuracies, the test predictions and labels (host arrays), the
    seconds of the precompute and of the fit, and ``impl``, the path the
    precompute took (``"cache"`` when the features came from
    ``feat_cache``)."""
    cfg = cfg.resolve()
    dev = resolve_device(device)
    generator = set_seed(cfg.seed)
    data = load_corpus(cfg.dataset, subset, data_path, fold=fold, device=dev)
    binary = cfg.dataset == "mr"

    if cfg.preprocessed and not feat_cache:
        raise ValueError("--preprocessed requires --feat_cache <path>")
    if cfg.preprocessed and _npz_path(Path(feat_cache)).exists():
        feat_dict = load_features(feat_cache, dev)
        precompute_time, path = 0.0, "cache"
    else:
        path = text_impl(data.graph, impl, cfg.degree)
        feat_dict, precompute_time = text_structural_features(
            data.graph, data.index_dict, degree=cfg.degree, impl=impl)
        if feat_cache:
            save_features(feat_cache, feat_dict)

    label_dict = {k: torch.as_tensor(v, device=dev)
                  for k, v in data.label_dict.items()}
    nclass = 1 if binary else data.n_classes
    params = init_sgc(generator, feat_dict["train"].shape[1], nclass,
                      bias=False, init="xavier_normal", device=dev)

    cw = None
    if class_weights and not binary:
        # inverse-frequency class weights (the fork's trainv2)
        counts = torch.bincount(label_dict["train"], minlength=nclass)
        cw = counts.sum() / torch.clamp(counts, min=1) / nclass

    params, train_time = train_linear(
        params, feat_dict["train"], label_dict["train"],
        weight_decay=cfg.weight_decay, epochs=cfg.epochs, binary=binary,
        class_weights=cw, trainer=trainer)

    res = {phase: eval_linear(params, feat_dict[phase], label_dict[phase],
                              binary)
           for phase in ("train", "val", "test")}
    return {
        "train_accuracy": res["train"]["accuracy"],
        "val_accuracy": res["val"]["accuracy"],
        "test_accuracy": res["test"]["accuracy"],
        "predictions": res["test"]["predictions"].cpu().numpy(),
        "test_labels": data.label_dict["test"],
        "params": params,
        "impl": path,
        "precompute_time": precompute_time,
        "train_time": train_time,
        "total_time": precompute_time + train_time,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", default="20ng")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--degree", type=int, default=2)
    parser.add_argument("--subset", default="BCD",
                        choices=["B", "BC", "BD", "BCD"])
    parser.add_argument("--tuned", action="store_true")
    parser.add_argument("--preprocessed", action="store_true")
    parser.add_argument("--feat_cache", default=None,
                        help="npz feature-dict path for --preprocessed")
    parser.add_argument("--fold", type=int, default=None,
                        help="cross-validation fold index")
    parser.add_argument("--class_weights", action="store_true")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--impl", default="auto", choices=list(TEXT_IMPLS),
                        help="S^{K-1} hop formulation of the structural "
                             "precompute (blockdense = bf16 cells on "
                             "kernel A + remainder on kernel B)")
    parser.add_argument("--trainer", default="lbfgs",
                        choices=["lbfgs", "newton"],
                        help="head fit: LBFGS (default) or the Newton/MM "
                             "trainer")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()

    cfg = TextConfig(dataset=args.dataset, seed=args.seed,
                     epochs=args.epochs, weight_decay=args.weight_decay,
                     degree=args.degree, tuned=args.tuned,
                     preprocessed=args.preprocessed)
    res = run(cfg, subset=args.subset, data_path=args.data_path,
              fold=args.fold, class_weights=args.class_weights,
              feat_cache=args.feat_cache, impl=args.impl,
              trainer=args.trainer, device=args.device)
    print(f"impl: {res['impl']} (asked {args.impl})")
    print("Total Time: {:2f}s, Train acc: {:.4f}, Val acc: {:.4f}, "
          "Test acc: {:.4f}".format(res["total_time"],
                                    res["train_accuracy"],
                                    res["val_accuracy"],
                                    res["test_accuracy"]))


if __name__ == "__main__":
    main()
