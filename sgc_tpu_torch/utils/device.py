"""Device selection shared by the port's entry points.

Every public entry point takes ``device=None``, which means the CUDA card.
Without one it raises: the port runs on the CPU only when the caller asks
for it with ``device="cpu"`` (as the tests do), never as a silent
fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present); any
    other value is passed to :class:`torch.device` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is absent")
    return dev
