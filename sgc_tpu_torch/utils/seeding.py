"""Seeding (the counterpart of sgc_tpu/utils/seeding.py).

The reference mints a JAX root key; the port returns a seeded
``torch.Generator`` that callers pass to every random draw (init,
dropout), so no global torch state is touched. numpy's global state is
seeded as in the reference, for host-side preprocessing.
"""

from __future__ import annotations

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy's global state and return a CPU ``torch.Generator``
    seeded with ``seed``."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
