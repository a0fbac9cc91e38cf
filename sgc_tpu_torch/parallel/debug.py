"""Exchange validation and determinism checks (the counterpart of
sgc_tpu/parallel/debug.py).

* :func:`validate_exchange`: every rank checksums the boundary rows it
  sends to each destination, the checksums ride a second all_to_all as
  a side channel, and each receiver recomputes them over the rows it
  received. A mismatch names the (src part, dst part) pair whose
  exchange corrupted data. ``inject_fault`` corrupts one block after
  transport, to show the check sees real corruption.
* :func:`assert_deterministic`: runs a function twice and asserts
  identical bits.
"""

from __future__ import annotations

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import host
from sgc_tpu_torch.parallel.mesh import NODES_AXIS, Mesh


def _fold_checksum(blocks: torch.Tensor) -> torch.Tensor:
    """Position-sensitive checksum of each ``(H, F)`` block of ``[P, H,
    F]``: row i weighs i + 1, so rows delivered in the wrong order change
    it. Cheap, not cryptographic. Returns ``[P]``, summed in float64 (the
    reference sums in f32, where at Reddit's width, H in the thousands
    and F = 602, a sum near 1e9 absorbs a corrupted value's change)."""
    x = blocks.double()
    w = torch.arange(1, x.shape[1] + 1, dtype=torch.float64,
                     device=x.device)[None, :, None]
    return (w * x).sum(dim=(1, 2)) + 0.5 * (w * x.abs()).sum(dim=(1, 2))


def validate_exchange(mesh: Mesh, send_idx, x_local: torch.Tensor,
                      inject_fault: tuple[int, int] | None = None
                      ) -> np.ndarray:
    """Checksum-validate one halo exchange over the mesh (a collective).

    ``send_idx`` is the plan's ``int32[P, P, H]`` (every rank holds it),
    ``x_local`` this rank's tile. Returns the ``(P, P)`` matrix of
    |sent - received| checksum deltas (row = receiving part, col =
    sending part) on every rank; all zero means the exchange was
    faithful. Raises AssertionError on any mismatch.

    ``inject_fault=(src, dst)`` adds 1.0 to the first value of the block
    that ``dst`` received from ``src``.
    """
    n_parts = mesh.shape[NODES_AXIS]
    me = mesh.coords[NODES_AXIS]
    si = torch.as_tensor(host(send_idx[me]).reshape(-1).astype(np.int64),
                         device=x_local.device)
    h = si.shape[0] // n_parts
    send = x_local.index_select(0, si)                      # (P*H, F)
    sent_sums = _fold_checksum(send.reshape(n_parts, h, -1))
    halo = mesh.all_to_all(NODES_AXIS, send)
    blk = halo.reshape(n_parts, h, -1)
    if inject_fault is not None:
        src, dst = inject_fault
        if me == dst:
            blk = blk.clone()
            blk[src, 0, 0] += 1.0
    recv_sums = _fold_checksum(blk)
    # each sent checksum travels to its destination for the comparison
    sent_at_dst = mesh.all_to_all(NODES_AXIS,
                                  sent_sums.reshape(n_parts, 1))
    row = (sent_at_dst.reshape(n_parts) - recv_sums).abs()
    deltas = host(mesh.all_gather(NODES_AXIS, row[None, :]))

    bad = np.argwhere(deltas > 0)
    if bad.size:
        dst, src = bad[0]
        raise AssertionError(
            f"halo exchange corruption: src part {src} -> dst part {dst} "
            f"checksum delta {deltas[dst, src]:.3e} "
            f"({len(bad)} corrupted pairs total)")
    return deltas


def _leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [np.asarray(host(tree))]


def assert_deterministic(fn, *args, runs: int = 2) -> None:
    """Run ``fn`` ``runs`` times; assert bitwise-identical outputs
    (tensors, arrays, or lists, tuples and dicts of them)."""
    ref = _leaves(fn(*args))
    for r in range(1, runs):
        got = _leaves(fn(*args))
        for a, b in zip(ref, got):
            if not np.array_equal(a, b):
                diff = np.abs(a.astype(np.float64)
                              - b.astype(np.float64)).max()
                raise AssertionError(
                    f"non-deterministic result on run {r}: max |delta| "
                    f"{diff}")
