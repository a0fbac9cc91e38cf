"""The TPU experiment probes of ``scripts/exp_*.py`` that reach a Pallas
kernel, on the card: ``python -m sgc_tpu_torch.scripts.<name>``.

Each module keeps the reference script's name and flags (plus
``--device``, default the card) and prints the reference's lines with the
same fields; its ``run(...)`` takes placed tensors, so that callers drive
it without argv. The kernels they launch are E (``ops/probe_copy.py``),
F (``ops/row_gather.py``), G (``ops/edge_accumulate.py``) and H
(``ops/blockdense_int8.py``).
"""

from __future__ import annotations

import argparse

import torch


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
