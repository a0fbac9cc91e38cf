"""Experiment sweep CLI: propagation depth K per dataset, with a results
table (the counterpart of sgc_tpu/cli/sweep.py), on the card by default:

    python -m sgc_tpu_torch.cli.sweep --datasets cora citeseer --degrees 1 2 3

Each added K costs one more hop on the previous depth's features (kernel
B through ``spmm(impl="segment")``), so the hops run once up to the
largest K; each K then trains its own head from the same init with Adam.
"""

from __future__ import annotations

import argparse
import json
import time

from sgc_tpu_torch.data.planetoid import load_citation
from sgc_tpu_torch.models.sgc import init_sgc, sgc_apply
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.spmm import spmm
from sgc_tpu_torch.train.loops import train_regression
from sgc_tpu_torch.train.metrics import accuracy
from sgc_tpu_torch.utils.config import load_tuned
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync
from sgc_tpu_torch.utils.seeding import set_seed


def sweep(datasets: list[str], degrees: list[int], epochs: int = 100,
          lr: float = 0.2, weight_decay: float | None = None,
          tuned: bool = True, seed: int = 42, data_path: str | None = None,
          device=None) -> list[dict]:
    """One row per (dataset, K): val/test accuracy, the hops' seconds up
    to K (``precompute_s``), the head's train seconds and the weight
    decay (the tuned one unless ``weight_decay`` is given)."""
    dev = resolve_device(device)
    rows = []
    for ds in datasets:
        set_seed(seed)
        data = load_citation(ds, data_path=data_path, device=dev)
        wd = weight_decay
        if wd is None:
            tuned_cfg = load_tuned("citation", ds) if tuned else {}
            wd = tuned_cfg.get("weight_decay", 5e-6)

        kernels.load_all(dev)
        x = data.features
        feats_at_k = {0: x}
        per_hop_t = {}
        t0 = time.perf_counter()
        for k in range(1, max(degrees) + 1):
            x = spmm(data.graph, x, impl="segment")
            sync(dev)
            feats_at_k[k] = x
            per_hop_t[k] = time.perf_counter() - t0

        for k in sorted(degrees):
            feats = feats_at_k[k]
            # every K starts from the same init
            model = init_sgc(set_seed(seed), feats.shape[1],
                             data.n_classes, device=dev)
            model, t_train = train_regression(
                model, feats[data.idx_train], data.labels[data.idx_train],
                epochs=epochs, weight_decay=wd, lr=lr)
            logits = sgc_apply(model, feats)
            rows.append({
                "dataset": ds,
                "K": k,
                "val_acc": round(accuracy(logits[data.idx_val],
                                          data.labels[data.idx_val]), 4),
                "test_acc": round(accuracy(logits[data.idx_test],
                                           data.labels[data.idx_test]), 4),
                "precompute_s": round(per_hop_t.get(k, 0.0), 4),
                "train_s": round(t_train, 4),
                "weight_decay": wd,
            })
    return rows


def print_table(rows: list[dict]) -> None:
    if not rows:
        return
    cols = list(rows[0].keys())
    widths = [max(len(c), max(len(str(r[c])) for r in rows)) for c in cols]
    line = "  ".join(c.ljust(w) for c, w in zip(cols, widths))
    print(line)
    print("-" * len(line))
    for r in rows:
        print("  ".join(str(r[c]).ljust(w) for c, w in zip(cols, widths)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="+", default=["cora"])
    p.add_argument("--degrees", nargs="+", type=int, default=[1, 2, 3])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--no_tuned", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data_path", default=None)
    p.add_argument("--json", action="store_true", help="jsonl output")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args()

    rows = sweep(a.datasets, a.degrees, epochs=a.epochs, lr=a.lr,
                 weight_decay=a.weight_decay, tuned=not a.no_tuned,
                 seed=a.seed, data_path=a.data_path, device=a.device)
    if a.json:
        for r in rows:
            print(json.dumps(r))
    else:
        print_table(rows)


if __name__ == "__main__":
    main()
