"""Score prediction snapshots in the results-txt format (the counterpart
of sgc_tpu/cli/score_results.py); host numpy work.

A results file is a concatenated ``[predictions; labels]`` vector, one
integer a line, as ``cli.crossval`` writes it. This CLI scores any such
file, so that numbers from either package, and archived runs, go through
one code path:

    python -m sgc_tpu_torch.cli.score_results results/covid*.results.txt

Per file: accuracy, macro-F1, weighted-F1, Optimized Precision; plus the
mean ± std across files (the trainv2 aggregate block).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from sgc_tpu_torch.train.metrics import f1_macro, f1_weighted, optimized_precision


def score_file(path: str | Path) -> dict:
    """Score one [pred; label] results file."""
    v = np.atleast_1d(np.loadtxt(path))
    if len(v) % 2:
        raise ValueError(f"{path}: odd length {len(v)} — not [pred;label]")
    n = len(v) // 2
    preds = v[:n].astype(np.int64)
    labels = v[n:].astype(np.int64)
    return {
        "file": str(path),
        "n": int(n),
        "accuracy": float((preds == labels).mean()),
        "f1_macro": f1_macro(preds, labels),
        "f1_weighted": f1_weighted(preds, labels),
        "op_score": optimized_precision(preds, labels),
    }


def score_files(paths: list) -> dict:
    rows = [score_file(p) for p in paths]
    agg = {}
    if len(rows) > 1:
        for key in ("accuracy", "f1_macro", "f1_weighted", "op_score"):
            vals = [r[key] for r in rows]
            agg[f"{key}_mean"] = float(np.mean(vals))
            agg[f"{key}_std"] = float(np.std(vals))
    return {"files": rows, "aggregate": agg}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("paths", nargs="+")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args()

    out = score_files(args.paths)
    if args.json:
        print(json.dumps(out, indent=2))
        return
    for r in out["files"]:
        print(
            f"{Path(r['file']).name}: n={r['n']} acc {r['accuracy']:.4f} "
            f"macroF1 {r['f1_macro']:.4f} wF1 {r['f1_weighted']:.4f} "
            f"OP {r['op_score']:.4f}"
        )
    if out["aggregate"]:
        a = out["aggregate"]
        print(
            "aggregate: acc {:.4f} ± {:.4f}  wF1 {:.4f} ± {:.4f}  "
            "OP {:.4f} ± {:.4f}".format(
                a["accuracy_mean"], a["accuracy_std"],
                a["f1_weighted_mean"], a["f1_weighted_std"],
                a["op_score_mean"], a["op_score_std"],
            )
        )


if __name__ == "__main__":
    main()
