"""Bounded memo for host-side builds keyed on buffer identity (the
counterpart of sgc_tpu/utils/buildcache.py).

The tiled layout and the hybrid split are O(E) host work on immutable
edge arrays that K-hop loops pass again and again, so they are cached by
the ``id()`` of those arrays plus the build parameters. The source
arrays are pinned inside the entry: a freed array's id could otherwise
be reused by a different array and alias the key. :func:`placed` is the
one such memo behind the port's drop-in SpMMs; it also holds each
layout's arrays on the device, and :func:`clear_placed` frees them.
"""

from __future__ import annotations

from typing import Callable


class HostBuildCache:
    """id()-keyed, pin-and-evict memo with FIFO eviction.

    ``get(pins, extra, build)``: ``pins`` are the large source objects
    whose identity keys the entry (kept alive while the entry is);
    ``extra`` is a hashable tuple of build parameters. ``build`` runs on
    a miss. ``find(pins, extra)`` is the cached value or None, and builds
    nothing.
    """

    def __init__(self, max_entries: int = 8):
        self._store: dict = {}
        self._max = max_entries

    def get(self, pins: tuple, extra: tuple, build: Callable):
        key = tuple(id(p) for p in pins) + tuple(extra)
        hit = self._store.get(key)
        if hit is not None:
            return hit[1]
        value = build()
        if len(self._store) >= self._max:
            self._store.pop(next(iter(self._store)))
        self._store[key] = (pins, value)
        return value

    def find(self, pins: tuple, extra: tuple):
        hit = self._store.get(tuple(id(p) for p in pins) + tuple(extra))
        return None if hit is None else hit[1]

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        """Drop every entry and the pins that keep its sources alive."""
        self._store.clear()


# The drop-in SpMMs (tiled, hybrid, block-dense): each entry is a host
# layout and its arrays placed on one device, held together. The placed
# arrays can take GBs of device memory; clear_placed() releases them.
_PLACED = HostBuildCache(4)


def placed(graph, params: tuple, device, build: Callable,
           place: Callable, by_vals: bool = True):
    """``(layout, args)`` for ``graph`` under ``params`` on ``device``:
    ``layout = build()`` and ``args = place(layout, device)`` on first
    use, the cached pair afterwards. ``graph`` is a SparseGraph; its edge
    arrays key the entry, its values only when ``by_vals`` (a layout of
    the pattern alone, as the transpose's, serves every reweighting)."""
    def make():
        layout = build()
        return layout, place(layout, device)

    pins = (graph.rows, graph.cols) + ((graph.vals,) if by_vals else ())
    return _PLACED.get(pins, (graph.nnz, graph.n_rows, graph.n_cols, by_vals,
                              *params, str(device)), make)


def clear_placed() -> None:
    """Drop every cached layout and the device memory its arrays hold."""
    _PLACED.clear()
