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


def rank_device(device=None) -> torch.device:
    """A rank's device: ``None`` -> ``cuda:(local_rank % device_count)``,
    the local rank read from ``LOCAL_RANK`` (set by torchrun and by
    ``parallel.distributed.launch``), else the process group's rank,
    else 0; raises when no CUDA device is present. Any other value as in
    :func:`resolve_device`."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    import os

    import torch.distributed as dist

    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        rank = int(local)
    else:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())
