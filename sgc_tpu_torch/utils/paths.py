"""Dataset path resolution (the counterpart of sgc_tpu/utils/paths.py).

Datasets are external files (Planetoid pickles, the Reddit npz pair). The
search order is the reference's: an explicit argument, then the
``SGC_TPU_DATA`` environment variable, then ``./data`` in the working
directory. The reference's last candidate, a read-only checkout of the
original project mounted beside it, has no counterpart here, and with
one candidate left its ``marker`` (which file a candidate must hold to be
preferred) has nothing to choose between.
"""

from __future__ import annotations

import os
from pathlib import Path


def data_dir(explicit: str | os.PathLike | None = None) -> Path:
    """Resolve the dataset directory; raises when none is found. A
    directory found without the dataset's files makes the loader raise,
    naming the missing file."""
    if explicit is not None:
        return Path(explicit)
    env = os.environ.get("SGC_TPU_DATA")
    if env:
        return Path(env)
    local = Path.cwd() / "data"
    if local.is_dir():
        return local
    raise FileNotFoundError(
        "no dataset directory found: pass a path, set SGC_TPU_DATA, or "
        "create ./data")
