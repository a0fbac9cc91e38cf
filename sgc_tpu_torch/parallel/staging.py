"""Per-rank host staging: a feature matrix larger than any one device,
built tile by tile from a row provider (the counterpart of
sgc_tpu/parallel/staging.py).

A row *provider* is a callable ``provider(start, stop) -> ndarray`` of
shape ``[stop - start, n_cols]`` with ``.shape`` and ``.dtype``
attributes: a memory-mapped ``.npy`` (:class:`mmap_rows`), a generator
(:class:`synthetic_features`), a slice of a larger store. Each rank asks
it only for its own part's rows, cuts its "feat" columns, zero-pads rows
and columns as the reference does, and places the tile on its device:

    provider = synthetic_features(n_rows, n_cols, seed=0)
    x_tile = stage_rows(mesh, provider)          # [R, F_pad / n_feat]

The host block is released once the copy to the device has completed
(a synchronizing call closes it), so a rank holds at most one tile on
the host at a time, and the full matrix exists nowhere.

``V5E_HBM_BYTES`` is the reference's TPU v5e figure, kept for parity of
:func:`sharding_report`'s keys; it says nothing about an H100. The
report measures the tile against the rank's own device memory
(``torch.cuda.get_device_properties(dev).total_memory``).
"""

from __future__ import annotations

import numpy as np
import torch

from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, Mesh
from sgc_tpu_torch.utils.profiling import sync

# one TPU v5e chip's HBM (the reference's capacity bar; a TPU figure)
V5E_HBM_BYTES = 16 * 1024**3


def is_provider(obj) -> bool:
    """A row provider: callable with a 2-D ``shape``, and not an array."""
    return (callable(obj)
            and not isinstance(obj, (np.ndarray, torch.Tensor))
            and hasattr(obj, "shape") and len(obj.shape) == 2)


class mmap_rows:
    """Row provider over an on-disk ``.npy``, memory-mapped: a call reads
    only the rows it asks for."""

    def __init__(self, path):
        self._arr = np.load(path, mmap_mode="r")
        if self._arr.ndim != 2:
            raise ValueError(f"{path}: expected 2-D array, got "
                             f"{self._arr.shape}")
        self.shape = self._arr.shape
        self.dtype = self._arr.dtype

    def __call__(self, start: int, stop: int) -> np.ndarray:
        return np.asarray(self._arr[start:stop])


class synthetic_features:
    """Deterministic synthetic rows with O(1) state: a splitmix64-style
    hash of (row, col, seed), uniform in [-0.5, 0.5); any row range gives
    the reference's bits."""

    def __init__(self, n_rows: int, n_cols: int, seed: int = 0,
                 dtype=np.float32):
        self.shape = (int(n_rows), int(n_cols))
        self.dtype = np.dtype(dtype)
        self.seed = int(seed)

    def __call__(self, start: int, stop: int) -> np.ndarray:
        i = np.arange(start, stop, dtype=np.uint64)[:, None]
        j = np.arange(self.shape[1], dtype=np.uint64)[None, :]
        h = (i * np.uint64(0x9E3779B97F4A7C15)
             + j * np.uint64(0xC2B2AE3D27D4EB4F)
             + np.uint64((self.seed * 0xD6E8FEB86659FD93 + 1)
                         & 0xFFFFFFFFFFFFFFFF))
        h ^= h >> np.uint64(31)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        # top 24 bits -> [0, 1) -> [-0.5, 0.5)
        vals = (h >> np.uint64(40)).astype(np.float32) / np.float32(2**24)
        return (vals - np.float32(0.5)).astype(self.dtype, copy=False)


def stage_block(provider, rows: slice, cols: slice, dtype,
                device) -> torch.Tensor:
    """The block ``[rows, cols]`` of the provider's matrix zero-padded
    beyond its shape, on ``device``: one provider call for the block's
    valid rows (none when they are all padding). The host block is gone
    when this returns: the copy is complete."""
    n_rows, n_cols = (int(s) for s in provider.shape)
    out = np.zeros((rows.stop - rows.start, cols.stop - cols.start),
                   np.dtype(dtype))
    vr = min(rows.stop, n_rows) - rows.start
    vc = min(cols.stop, n_cols) - cols.start
    if vr > 0 and vc > 0:
        block = np.asarray(provider(rows.start, rows.start + vr))
        out[:vr, :vc] = block[:, cols.start:cols.start + vc]
        del block
    tile = torch.from_numpy(out).to(device)
    # the copy has landed before the host block is released
    sync(tile.device)
    return tile


def stage_rows(mesh: Mesh, provider, n_rows_padded: int | None = None,
               n_cols_padded: int | None = None,
               dtype=np.float32) -> torch.Tensor:
    """This rank's ``(nodes, feat)`` tile of the ``[n_rows_padded,
    n_cols_padded]`` matrix the provider defines (rows and columns past
    its shape are zero), placed on the mesh's device.

    Defaults pad rows to the "nodes" axis and columns to 8x the "feat"
    axis (the tiling ``fit_sharded`` uses), as the reference.
    """
    n_rows, n_cols = (int(s) for s in provider.shape)
    n_nodes, n_feat = mesh.shape[NODES_AXIS], mesh.shape[FEAT_AXIS]
    if n_rows_padded is None:
        n_rows_padded = -(-n_rows // n_nodes) * n_nodes
    if n_cols_padded is None:
        mult = 8 * n_feat
        n_cols_padded = -(-n_cols // mult) * mult
    if n_rows_padded < n_rows:
        raise ValueError(f"n_rows_padded {n_rows_padded} < provider rows "
                         f"{n_rows}")
    if n_cols_padded < n_cols:
        raise ValueError(f"n_cols_padded {n_cols_padded} < provider cols "
                         f"{n_cols}")
    for size, n, axis in ((n_rows_padded, n_nodes, NODES_AXIS),
                          (n_cols_padded, n_feat, FEAT_AXIS)):
        if size % n:
            raise ValueError(f"{size} does not divide over {n} {axis!r} "
                             "shards")
    r = n_rows_padded // n_nodes
    c = n_cols_padded // n_feat
    i, j = mesh.coords[NODES_AXIS], mesh.coords[FEAT_AXIS]
    return stage_block(provider, slice(i * r, (i + 1) * r),
                       slice(j * c, (j + 1) * c), dtype, mesh.device)


def sharding_report(mesh: Mesh, tile: torch.Tensor) -> dict:
    """Size evidence for a ``(nodes, feat)``-sharded matrix from this
    rank's tile: the global shape and bytes, the tile's bytes, the
    reference's v5e keys (a TPU capacity, for parity) and the tile
    against this rank's device memory (None off a card)."""
    rows, cols = (int(s) for s in tile.shape)
    shape = (rows * mesh.shape[NODES_AXIS], cols * mesh.shape[FEAT_AXIS])
    total = shape[0] * shape[1] * tile.element_size()
    per_dev = tile.numel() * tile.element_size()
    capacity = (torch.cuda.get_device_properties(tile.device).total_memory
                if tile.device.type == "cuda" else None)
    return {
        "global_shape": shape,
        "global_gb": round(total / 1e9, 2),
        "n_shards": mesh.size,
        "per_device_gb": round(per_dev / 1e9, 3),
        "exceeds_v5e_hbm": total > V5E_HBM_BYTES,
        "fits_per_device_v5e": per_dev < V5E_HBM_BYTES,
        "device_memory_bytes": capacity,
        "exceeds_device_memory": (None if capacity is None
                                  else total > capacity),
        "fits_per_device": (None if capacity is None
                            else per_dev < capacity),
    }
