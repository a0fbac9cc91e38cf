"""Timing helpers (the counterpart of sgc_tpu/utils/profiling.py)."""

from __future__ import annotations

import torch


def sync(device=None) -> None:
    """Wait for every queued kernel on ``device`` (a no-op on the CPU),
    so a host clock read after it closes the timed work."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(dev)
