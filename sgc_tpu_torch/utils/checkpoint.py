"""The propagated-feature cache (the counterpart of the feature functions
of sgc_tpu/utils/checkpoint.py): a phase -> array dict as one ``.npz``,
the file format of the reference, which ``textsgc --preprocessed
--feat_cache`` reads back instead of propagating again. The reference's
per-hop ``PropagationCheckpointer`` and its params checkpoints are not
ported yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sgc_tpu_torch.utils.device import resolve_device


def _npz_path(path: Path) -> Path:
    # np.savez appends .npz itself; normalize so that save and load agree
    # for suffixless paths (--feat_cache feats.pkl)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def save_array_dict(path: str | Path, arrays: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(_npz_path(path), **{
        k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        for k, v in arrays.items()})


def load_array_dict(path: str | Path, device=None) -> dict:
    """The arrays as tensors on ``device`` (``None`` -> the card)."""
    dev = resolve_device(device)
    with np.load(_npz_path(Path(path))) as f:
        return {k: torch.from_numpy(f[k]).to(dev) for k in f.files}


def save_features(path: str | Path, feat_dict: dict) -> None:
    """Save a phase -> features dict (the TextSGC preprocessed format)."""
    save_array_dict(path, feat_dict)


def load_features(path: str | Path, device=None) -> dict:
    return load_array_dict(path, device)
