"""Checkpoints (the counterpart of sgc_tpu/utils/checkpoint.py:1-205):

* ``save_features`` / ``load_features``: the propagated-feature cache, a
  phase -> array dict as one ``.npz``, which ``textsgc --preprocessed
  --feat_cache`` reads back instead of propagating again;
* ``save_params`` / ``load_params``: an SGC head as the reference's
  ``leaf_{i}`` npz, in JAX's leaf order (``w``, then ``b`` when there is
  one), so a head saved by either package loads in the other;
* ``PropagationCheckpointer`` / ``propagate_with_checkpoints``: per-hop
  checkpoints of the K-hop propagation, whose hop k is a complete
  restart point, keyed by ``propagation_fingerprint``.

The reference's orbax ``save_sharded`` / ``load_sharded`` go with
distribution (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import host
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


def save_params(path: str | Path, params) -> None:
    """Save an SGC head as ``leaf_0`` = ``w`` (and ``leaf_1`` = ``b``),
    the npz of the reference's ``save_params``. No ``.treedef`` sidecar is
    written: the reference's unpickles a JAX ``PyTreeDef``, so it loads
    this file with ``like=``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = [params.w] + ([] if params.b is None else [params.b])
    np.savez(_npz_path(path), **{f"leaf_{i}": host(t).astype(np.float32)
                                 for i, t in enumerate(leaves)})


def load_params(path: str | Path, like=None, device=None):
    """An SGC head from a ``save_params`` npz of either package, on
    ``device`` (``None`` -> the card). Nothing is unpickled: the structure
    comes from ``like`` (an SGC, whose ``b`` says whether a bias leaf is
    expected) or from the leaf count (1: ``w``; 2: ``w``, ``b``; JAX
    flattens ``b=None`` to no leaf)."""
    from sgc_tpu_torch.models.sgc import SGC

    dev = resolve_device(device)
    with np.load(_npz_path(Path(path))) as f:
        leaves = [f[f"leaf_{i}"] for i in range(len(f.files))]
    want = (1 if like.b is None else 2) if like is not None else None
    if want is not None and want != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves but `like` "
                         f"structure expects {want}")
    if len(leaves) not in (1, 2):
        raise ValueError(f"checkpoint has {len(leaves)} leaves; an SGC "
                         "head has 1 (w) or 2 (w, b)")
    ts = [torch.from_numpy(np.asarray(t, np.float32)).to(dev)
          for t in leaves]
    return SGC(ts[0], ts[1] if len(ts) == 2 else None).requires_grad_(False)


def propagation_fingerprint(graph, x, degree: int) -> str:
    """Content-aware restart key (checkpoint.py:101-124): the graph's
    shape and live edges, x's shape and four sums of x. Computed on the
    host with numpy from f32 arrays, so the digest equals the
    reference's for the same inputs."""
    h = hashlib.sha1()
    h.update(np.asarray([graph.n_rows, graph.n_cols, graph.nnz],
                        np.int64).tobytes())
    for a in (graph.rows, graph.vals, graph.cols):
        h.update(host(a)[: graph.nnz].tobytes())
    xs = host(x)
    h.update(np.asarray([xs.shape[0], xs.shape[1]], np.int64).tobytes())
    h.update(np.asarray(
        [float(xs.sum()), float(np.abs(xs).sum()),
         float(xs[0].sum()), float(xs[-1].sum())], np.float64).tobytes())
    return f"k{degree}_{h.hexdigest()[:16]}"


class PropagationCheckpointer:
    """Per-hop checkpoint/resume for K-hop propagation::

        ckpt = PropagationCheckpointer(dir, fingerprint)
        x, start_hop = ckpt.restore(x0)
        for k in range(start_hop, K):
            x = spmm(graph, x)
            ckpt.save_hop(k, x)
    """

    def __init__(self, directory: str | Path, fingerprint: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fingerprint = fingerprint
        self._meta_path = self.dir / "meta.json"

    def _load_meta(self) -> dict:
        # a half-written meta (a crash mid-save) reads as "no checkpoint"
        try:
            with open(self._meta_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def save_hop(self, hop: int, x: torch.Tensor) -> None:
        save_array_dict(self.dir / f"hop_{hop}.npz", {"x": x})
        # atomic meta update, then drop the superseded hop (only the
        # last completed hop is ever restored)
        tmp = self._meta_path.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump({"fingerprint": self.fingerprint, "last_hop": hop}, f)
        os.replace(tmp, self._meta_path)
        prev = self.dir / f"hop_{hop - 1}.npz"
        if hop > 0 and prev.exists():
            prev.unlink()

    def restore(self, x0: torch.Tensor) -> tuple[torch.Tensor, int]:
        """``(features, next_hop)`` on x0's device; ``(x0, 0)`` when there
        is no checkpoint under this fingerprint."""
        meta = self._load_meta()
        if meta.get("fingerprint") != self.fingerprint:
            return x0, 0
        hop = int(meta["last_hop"])
        path = self.dir / f"hop_{hop}.npz"
        if not path.exists():
            return x0, 0
        return load_array_dict(path, x0.device)["x"], hop + 1


def propagate_with_checkpoints(x: torch.Tensor, graph, degree: int,
                               checkpoint_dir: str | Path | None = None,
                               impl: str = "auto") -> torch.Tensor:
    """K-hop propagation through ``spmm`` (kernel B on the card under
    ``auto``), restartable from the last completed hop."""
    from sgc_tpu_torch.ops.spmm import spmm

    start, ckpt = 0, None
    if checkpoint_dir is not None:
        ckpt = PropagationCheckpointer(
            checkpoint_dir, propagation_fingerprint(graph, x, degree))
        x, start = ckpt.restore(x)
    for k in range(start, degree):
        x = spmm(graph, x, impl=impl)
        if ckpt is not None:
            ckpt.save_hop(k, x)
    return x
