"""Timing and logging helpers (the counterpart of
sgc_tpu/utils/profiling.py): ``sync`` closes a host-clock span on the
card, ``ScalarWriter`` logs scalar curves (``train_regression(writer=)``)."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch


def sync(device=None) -> None:
    """Wait for every queued kernel on ``device`` (a no-op on the CPU),
    so a host clock read after it closes the timed work."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(dev)


class ScalarWriter:
    """Append-only scalar event log (the SummaryWriter analog): one JSON
    line per event, ``{"step", "tag", "value", "wall"}``."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"step": step, "tag": tag,
                                  "value": float(value),
                                  "wall": time.time()}) + "\n")

    def scalars(self, tag: str, values, start_step: int = 0) -> None:
        for i, v in enumerate(values):
            self.scalar(tag, v, start_step + i)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
