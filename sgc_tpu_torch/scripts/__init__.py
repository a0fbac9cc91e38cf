"""The TPU experiments of ``scripts/exp_*.py`` on the card:
``python -m sgc_tpu_torch.scripts.<name>``.

Each module keeps the reference script's name and flags (plus
``--device``, default the card) and prints the reference's lines with the
same fields; its ``run(...)`` takes placed tensors, so that callers drive
it without argv. The probes launch kernels E (``ops/probe_copy.py``), F
(``ops/row_gather.py``), G (``ops/edge_accumulate.py``) and H
(``ops/blockdense_int8.py``).

Beside them, the experiments that answer the port's open questions on the
package's own paths (kernels A, B and C): ``exp_topology_sweep``,
``exp_beyond_device`` and ``exp_beyond_stages``, ``exp_newton_head``,
``exp_lbfgs_cost``, ``exp_pad_study``, ``exp_crossover``,
``exp_flat_sweep``, ``exp_hybrid_sweep`` and ``exp_super_rows``. Their
kernel calls are plain calls: where a reference script caught a
compile failure and printed it as a data point, a failure here raises.
Where a reference script states a TPU figure (a v5e rate or capacity),
the port keeps it under a name that says so and prints the device's own
figure beside it.
"""

from __future__ import annotations

import argparse
import sys

import torch

from sgc_tpu_torch.utils.profiling import timed_runs


def device_parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the port's ``--device`` flag."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def backend(device: torch.device) -> str:
    """The line the reference prints as ``jax.default_backend()``."""
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


def log(msg: str) -> None:
    """A line on stderr, where the reference scripts log."""
    print(msg, file=sys.stderr, flush=True)


def best_seconds(fn, reps: int) -> tuple[float, object]:
    """``(best seconds of reps runs after a warm one, last output)``, each
    run closed by a sync of its output (a host clock)."""
    ts, out = timed_runs(fn, reps)
    return min(ts), out

