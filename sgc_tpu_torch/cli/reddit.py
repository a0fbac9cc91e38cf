"""Reddit SGC training CLI, large-graph and inductive (the counterpart of
sgc_tpu/cli/reddit.py), on the card by default:

    python -m sgc_tpu_torch.cli.reddit --inductive --test
    python -m sgc_tpu_torch.cli.reddit --inductive --test --locality

Load and standardize (``data/reddit.py``); propagate the full graph K hops
for the eval features and, with ``--inductive``, the train-only
sub-adjacency for the train features (no test leakage); fit the linear
head (``--trainer newton``, the default, or ``lbfgs``, the oracle, ``lr``
1 and ``epochs`` 2); report micro and macro F1. ``--locality`` runs both
propagations through a ``LocalityPlan`` each (LPA reorder and per-hop
splits, admission calibrated on the device), rows restored to the
loader's numbering. ``--sharded`` propagates over a world of ranks the
CLI launches (``parallel.distributed.cli_world``: one rank per card over
NCCL, or with ``--device cpu`` the gloo ranks ``SGC_TPU_TORCH_CPU_RANKS``
names): the full graph partitioned over the ranks (transductive) or, with
``--inductive``, both adjacencies through ``parallel/inductive.py``;
``--formulation`` picks the sharded hop (``auto`` = ``blockdense``,
kernels A and B; ``segment``, kernel B); the head is fitted on the
gathered rows. The reference's argument errors (``--locality`` with
``--sharded``, ``--formulation`` without it) raise its ``ValueError``.

    python -m sgc_tpu_torch.cli.reddit --inductive --test --sharded
"""

from __future__ import annotations

import argparse
from time import perf_counter

import numpy as np
import torch

from sgc_tpu_torch.data.reddit import load_reddit
from sgc_tpu_torch.models.sgc import init_sgc, sgc_apply
from sgc_tpu_torch.ops.propagate import sgc_precompute
from sgc_tpu_torch.train.loops import train_linear
from sgc_tpu_torch.train.metrics import f1
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync
from sgc_tpu_torch.utils.seeding import set_seed

# seconds a sharded world may take before every rank is stopped
SHARDED_TIMEOUT_S = 3600.0


def run(inductive: bool = True, test: bool = True, degree: int = 2,
        epochs: int = 2, lr: float = 1.0, weight_decay: float = 0.0,
        normalization: str = "AugNormAdj", seed: int = 42,
        data_path: str | None = None, sharded: bool = False,
        locality: bool = False, formulation: str = "auto",
        trainer: str = "newton", device=None) -> dict:
    """One Reddit run; ``device=None`` means the card (raises without
    one). Besides the reference's keys the result holds ``load_time``
    (host seconds of the loader), with ``locality`` the plans'
    ``dense_frac``, and ``eval_features``, the propagated eval matrix in
    the loader's row numbering."""
    if locality and sharded:
        raise ValueError("--locality applies to the single-device path "
                         "(the sharded path partitions by node range)")
    if formulation != "auto" and not sharded:
        raise ValueError(
            "--formulation selects the SHARDED propagation kernel; pass "
            "--sharded with it (the --locality path has its own "
            "formulation auto-selection)")
    dev = resolve_device(device)
    generator = set_seed(seed)
    t0 = perf_counter()
    data = load_reddit(normalization, data_path, device=dev)
    sync(dev)
    load_time = perf_counter() - t0

    extra = {}
    if locality:
        feats_eval, feats_train, t_full, t_train_pre, extra = (
            _locality_propagate(data, degree, inductive, dev))
    elif sharded:
        feats_eval, feats_train, t_full = _sharded_propagate(
            data, degree, inductive, formulation, dev)
        t_train_pre = 0.0
    else:
        # eval features from the full graph
        feats_eval, t_full = sgc_precompute(data.features, data.graph,
                                            degree)
        if inductive:
            # train features from the train-only sub-adjacency
            feats_train, t_train_pre = sgc_precompute(
                data.features[data.idx_train], data.train_graph, degree)
        else:
            feats_train = feats_eval[data.idx_train]
            t_train_pre = 0.0

    model = init_sgc(generator, feats_eval.shape[1], data.n_classes,
                     bias=True, device=dev)
    model, train_time = train_linear(
        model, feats_train, data.labels[data.idx_train],
        weight_decay=weight_decay, epochs=epochs, lr=lr, trainer=trainer)

    split = data.idx_test if test else data.idx_val
    logits = sgc_apply(model, feats_eval[split])
    micro, macro = f1(logits, data.labels[split])
    precompute_time = t_full + t_train_pre
    return {
        "f1_micro": micro,
        "f1_macro": macro,
        "precompute_time": precompute_time,
        "train_time": train_time,
        "total_time": precompute_time + train_time,
        "load_time": load_time,
        **extra,
        "eval_features": feats_eval,
    }


def _locality_propagate(data, degree: int, inductive: bool, dev):
    """Eval features from the full graph and (inductive) train features
    from the train sub-adjacency, each through its own LocalityPlan
    (``calibrate=True``, as the reference), rows restored. Each timer
    covers a warm run of the hops on the device: the plan's (reordered)
    features are placed before it, as ``sgc_precompute``'s are. Plan
    builds are host prep, reported as ``host_prep_time``."""
    from sgc_tpu_torch.graph.locality import LocalityPlan
    from sgc_tpu_torch.graph.sparse import host
    from sgc_tpu_torch.ops.calibrate import measured_rates

    idx_train = np.asarray(data.idx_train)
    features = host(data.features)
    labels = host(data.labels)
    # the one-time calibration probe stays out of the prep time
    measured_rates(dev)

    t0 = perf_counter()
    plan_full = LocalityPlan.build(data.graph, features, labels, idx_train,
                                   calibrate=True, device=dev)
    prep_s = perf_counter() - t0
    x = torch.as_tensor(plan_full.features, device=dev)
    plan_full.propagate_all(degree, x)
    sync(dev)
    t0 = perf_counter()
    feats_eval = plan_full.propagate_all(degree, x)
    sync(dev)
    t_full = perf_counter() - t0
    extra = {"dense_frac": plan_full.dense_fraction}

    if inductive:
        t0 = perf_counter()
        plan_train = LocalityPlan.build(
            data.train_graph, features[idx_train], labels[idx_train],
            np.arange(len(idx_train)), calibrate=True, device=dev)
        prep_s += perf_counter() - t0
        x = torch.as_tensor(plan_train.features, device=dev)
        plan_train.propagate_all(degree, x)
        sync(dev)
        t0 = perf_counter()
        feats_train = plan_train.propagate_all(degree, x)
        sync(dev)
        t_train_pre = perf_counter() - t0
        extra["train_dense_frac"] = plan_train.dense_fraction
    else:
        feats_train = feats_eval[idx_train]
        t_train_pre = 0.0
    extra["host_prep_time"] = prep_s
    return feats_eval, feats_train, t_full, t_train_pre, extra


def _sharded_propagate(data, degree: int, inductive: bool,
                       formulation: str, dev):
    """Eval (and, inductive, train) features from the sharded propagation
    over the world ``cli_world(dev)`` starts, gathered into the loader's
    numbering on ``dev``; the time is the slowest rank's."""
    import tempfile

    from sgc_tpu_torch.graph.sparse import host
    from sgc_tpu_torch.parallel import bodies
    from sgc_tpu_torch.parallel.distributed import (
        cli_world,
        launch,
        save_host,
    )

    if formulation == "auto":
        formulation = "blockdense"
    if formulation not in ("segment", "blockdense"):
        raise ValueError(f"unknown formulation {formulation!r}")
    ranks, backend, rank_dev = cli_world(dev)
    with tempfile.TemporaryDirectory(prefix="sgc_reddit_") as root:
        bodies.write_inputs(root, data.graph, host(data.features),
                            host(data.labels), data.idx_train)
        if inductive:
            save_host(f"{root}/train_graph", data.train_graph)
        out = launch(bodies.cli_reddit, ranks, backend, f"{root}/init",
                     (root, {"degree": degree, "inductive": inductive,
                             "formulation": formulation,
                             "device": rank_dev}), SHARDED_TIMEOUT_S)[0]
        feats_eval = torch.as_tensor(np.load(f"{root}/eval.npy"),
                                     device=dev)
        feats_train = (torch.as_tensor(np.load(f"{root}/train.npy"),
                                       device=dev) if inductive
                       else feats_eval[data.idx_train])
    return feats_eval, feats_train, out["seconds"]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--inductive", action="store_true")
    parser.add_argument("--sharded", action="store_true",
                        help="partition both adjacencies over a world of "
                             "ranks (one per card)")
    parser.add_argument("--locality", action="store_true",
                        help="LPA community reorder + per-hop splits "
                             "(single device)")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--degree", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1.0)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--normalization", default="AugNormAdj")
    parser.add_argument("--data_path", default=None)
    parser.add_argument("--formulation", default="auto",
                        choices=["auto", "segment", "blockdense"],
                        help="sharded propagation kernel (auto = the "
                             "block-dense path)")
    parser.add_argument("--trainer", default="newton",
                        choices=["newton", "lbfgs"],
                        help="linear-head fit: accelerated Newton/MM "
                             "(default) or the LBFGS oracle")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()

    res = run(inductive=args.inductive, sharded=args.sharded,
              locality=args.locality, test=args.test, degree=args.degree,
              epochs=args.epochs, lr=args.lr,
              weight_decay=args.weight_decay,
              normalization=args.normalization, seed=args.seed,
              data_path=args.data_path, formulation=args.formulation,
              trainer=args.trainer, device=args.device)
    print("Total Time: {:.4f}s, {} F1: {:.4f}".format(
        res["total_time"], "Test" if args.test else "Validation",
        res["f1_micro"]))
    print("Pre-compute time: {:.4f}s, train time: {:.4f}s".format(
        res["precompute_time"], res["train_time"]))


if __name__ == "__main__":
    main()
