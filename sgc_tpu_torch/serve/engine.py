"""Batched inference engine for a trained SGC head (the counterpart of
sgc_tpu/serve/engine.py), on the card by default.

Request sizes are bucketed to powers of two between ``min_batch`` and
``max_batch`` and padded with row 0, as in the reference, so every
request runs one of a few shapes (each warmed once at start-up).

Two modes:

* **transductive**: logits for known node ids against the precomputed
  ``S^K X`` store, placed on the device once: a row gather and a matmul.
  With ``quantize_int8`` the store is per-row symmetric int8 (quantized
  on the host with numpy exactly as the reference, engine.py:157-167),
  dequantized after the gather.
  With ``shard_store`` the store (and its scales) is row-sharded over
  every card the process drives (:func:`store_devices`), rows
  zero-padded to the card count, one shard per ``cuda:i``; a request
  gathers its rows from each shard and reassembles them in request order
  on the engine's device before the same dequantize and matmul, so the
  logits equal the unsharded engine's bit for bit. A row provider
  (``parallel/staging.py``) is staged shard by shard, so the full store
  never exists in one buffer.
* **inductive**: logits for nodes from fixed-fanout sampled propagation
  over the graph and the raw features (ops/sampling.py), both placed on
  the device once; the sampling generator is seeded from
  ``EngineConfig.seed`` and advances with every call.

Host <-> device traffic goes through slots, each owning a pinned ids
buffer, a pinned logits buffer and a CUDA event: ids go up and logits
come back by ``non_blocking`` copies, and a fetch waits on the slot's
event. A slot is reused only after its fetch, so no copy can still be
reading or writing a buffer the host refills.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import host
from sgc_tpu_torch.models.sgc import SGC, sgc_apply
from sgc_tpu_torch.ops.sampling import sampled_propagate
from sgc_tpu_torch.parallel.staging import is_provider, stage_block
from sgc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 1024          # largest bucket
    min_batch: int = 8             # smallest bucket
    warmup: bool = True            # run every bucket once at start-up
    fanouts: tuple = (25, 10)      # inductive sampling fanouts
    quantize_int8: bool = False    # store features int8 + per-row scales
    shard_store: bool = False      # row-shard the store over the cards
    seed: int = 0


def _buckets(lo: int, hi: int) -> list[int]:
    if lo < 1 or lo > hi:
        raise ValueError(
            f"min_batch must satisfy 1 <= min_batch <= max_batch; got "
            f"min_batch={lo}, max_batch={hi} (min_batch 0 would loop "
            "forever doubling)")
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


@dataclasses.dataclass
class Stats:
    requests: int = 0
    rows: int = 0
    total_s: float = 0.0

    def __post_init__(self):
        # p50/p99 over the last 10k requests: a long-lived server must
        # not grow without bound
        self._lat = deque(maxlen=10_000)

    def observe(self, n_rows: int, dt: float) -> None:
        self.requests += 1
        self.rows += n_rows
        self.total_s += dt
        self._lat.append(dt)

    @property
    def mean_latency_ms(self) -> float:
        return 1e3 * self.total_s / max(self.requests, 1)

    def percentile_ms(self, q: float) -> float:
        """Latency percentile (q in [0, 100]) over the recent window."""
        if not self._lat:
            return 0.0
        return 1e3 * float(np.percentile(np.asarray(self._lat), q))


def store_devices(device: torch.device) -> list:
    """The devices a sharded store spans: every card of the process for
    an engine on a card, the engine's own device otherwise."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class _Slot:
    """One request's host buffers: ids up, logits back, and the event
    recorded after the logits' copy (none on the CPU, where every copy
    is synchronous)."""

    def __init__(self, max_batch: int, n_classes: int,
                 device: torch.device):
        pin = device.type == "cuda"
        self.ids = torch.empty(max_batch, dtype=torch.int32, pin_memory=pin)
        self.out = torch.empty((max_batch, n_classes), dtype=torch.float32,
                               pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None


class InferenceEngine:
    """Shape-bucketed batch forward for an SGC head.

    Args:
      params:   the trained head (``models/sgc.py::SGC``).
      features: transductive mode: float[N, F] precomputed ``S^K X``
                (numpy or a tensor).
      graph + raw_features: inductive mode: a SparseGraph and raw
                float[N, F] node features.
      device:   ``None`` -> the card (raises without one).
    """

    def __init__(self, params: SGC, features=None, graph=None,
                 raw_features=None, config: EngineConfig | None = None,
                 device=None):
        if (features is None) == (graph is None):
            raise ValueError(
                "exactly one of features= (transductive) or "
                "graph=+raw_features= (inductive) is required")
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.params = SGC(
            params.w.detach().to(self.device, torch.float32),
            None if params.b is None else
            params.b.detach().to(self.device, torch.float32),
        ).requires_grad_(False)
        self.stats = Stats()
        self._mode = "transductive" if features is not None else "inductive"
        self._scales = None
        self._generator = None
        # ids must fall in the store's rows, and in inductive mode in the
        # graph's too: an out-of-range id reaching a CUDA gather is a
        # device-side assert that ends the server
        if features is not None:
            self._n_nodes = int(features.shape[0])
        elif raw_features is not None:
            self._n_nodes = min(int(raw_features.shape[0]),
                                int(graph.n_rows))
        else:
            self._n_nodes = 0
        if is_provider(features):
            if not self.config.shard_store:
                raise ValueError(
                    "a row-provider feature store requires "
                    "shard_store=True (unsharded serving would "
                    "materialize the full matrix anyway)")
            if self.config.quantize_int8:
                raise ValueError(
                    "quantize_int8 quantizes the full store up front — "
                    "pre-quantize the provider instead")
        self._shards = None
        if self._mode == "transductive":
            store, scale = features, None
            if self.config.quantize_int8:
                f = np.asarray(host(features), np.float32)
                scale = np.abs(f).max(axis=1, keepdims=True) / 127.0
                scale = np.maximum(scale, 1e-12).astype(np.float32)
                store = np.clip(np.round(f / scale), -127, 127).astype(
                    np.int8)
            if self.config.shard_store:
                self._shards = self._shard(store, scale)
            elif scale is not None:
                self._features = torch.tensor(store, device=self.device)
                self._scales = torch.tensor(scale, device=self.device)
            else:
                self._features = self._place(features)
        else:
            if raw_features is None:
                raise ValueError("inductive mode requires raw_features=")
            if self.config.quantize_int8:
                raise ValueError(
                    "quantize_int8 is only supported in transductive mode "
                    "(sampled propagation needs full-precision features)")
            if self.config.shard_store:
                raise ValueError(
                    "shard_store is only supported in transductive mode")
            self._graph = graph.to(self.device)
            self._features = self._place(raw_features)
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.config.seed)

        self._bucket_sizes = _buckets(self.config.min_batch,
                                      self.config.max_batch)
        self._free: list[_Slot] = []
        if self.config.warmup:
            self.warmup()

    def _shard(self, store, scale) -> list:
        """``[(rows, scales or None), ...]``, one shard per store device,
        each ``ceil(N / D)`` rows (the last zero-padded)."""
        devs = store_devices(self.device)
        n, f = (int(d) for d in store.shape)
        self._rows_per_shard = per = -(-n // len(devs))
        out = []
        for i, dev in enumerate(devs):
            rows = slice(i * per, (i + 1) * per)
            if is_provider(store):
                block = stage_block(store, rows, slice(0, f), store.dtype,
                                    dev)
            else:
                a = host(store)[rows]
                block = self._pad_block(
                    a if scale is not None else a.astype(np.float32), per,
                    dev)
            sc = (None if scale is None
                  else self._pad_block(scale[rows], per, dev))
            out.append((block, sc))
        return out

    @staticmethod
    def _pad_block(a: np.ndarray, rows: int, device) -> torch.Tensor:
        out = np.zeros((rows,) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    def _gather_shards(self, ids: np.ndarray) -> torch.Tensor:
        """The store's rows ``ids`` (dequantized) on the engine's device:
        each shard gathers its own rows, and they are copied into request
        order (each position once)."""
        per = self._rows_per_shard
        shard = ids // per
        parts = []
        for s, (block, sc) in enumerate(self._shards):
            pos = np.flatnonzero(shard == s)
            if not len(pos):
                continue
            local = torch.from_numpy(ids[pos] - s * per).to(block.device)
            at = torch.from_numpy(pos).to(self.device)
            parts.append((at, block.index_select(0, local).to(self.device),
                          None if sc is None
                          else sc.index_select(0, local).to(self.device)))
        block0, sc0 = self._shards[0]
        rows = torch.empty((len(ids), block0.shape[1]), dtype=block0.dtype,
                           device=self.device)
        scales = (None if sc0 is None else torch.empty(
            (len(ids), 1), dtype=torch.float32, device=self.device))
        for at, r, sc in parts:
            rows.index_copy_(0, at, r)
            if scales is not None:
                scales.index_copy_(0, at, sc)
        if scales is not None:
            return rows.to(torch.float32) * scales
        return rows.to(torch.float32)

    def _place(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.detach().to(self.device, torch.float32).contiguous()
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    @property
    def n_classes(self) -> int:
        return int(self.params.w.shape[1])

    # -- device work ---------------------------------------------------------

    def _forward(self, ids: torch.Tensor,
                 host_ids: np.ndarray) -> torch.Tensor:
        if self._shards is not None:
            return sgc_apply(self.params, self._gather_shards(host_ids))
        if self._mode == "transductive":
            rows = self._features.index_select(0, ids)
            if self._scales is not None:
                rows = rows.to(torch.float32) * self._scales.index_select(
                    0, ids)
            return sgc_apply(self.params, rows)
        est = sampled_propagate(self._graph, self._features, ids,
                                self._generator, tuple(self.config.fanouts))
        return sgc_apply(self.params, est)

    def _take_slot(self) -> _Slot:
        if self._free:
            return self._free.pop()
        return _Slot(self.config.max_batch, self.n_classes, self.device)

    @torch.no_grad()
    def _dispatch(self, slot: _Slot, ids: np.ndarray, n: int) -> None:
        """Queue one bucket-padded request: ids up, forward, the first
        ``n`` logits back into the slot, then the slot's event."""
        b = ids.shape[0]
        slot.ids[:b].copy_(torch.from_numpy(ids))
        dev_ids = slot.ids[:b].to(self.device, non_blocking=True)
        slot.out[:n].copy_(self._forward(dev_ids, ids)[:n],
                           non_blocking=True)
        if slot.event is not None:
            slot.event.record()

    def _fetch(self, slot: _Slot, n: int) -> np.ndarray:
        """Wait for the slot's copies, copy its logits out, free it."""
        if slot.event is not None:
            slot.event.synchronize()
        out = slot.out[:n].numpy().copy()
        self._free.append(slot)
        return out

    def warmup(self) -> None:
        """Run every bucket once, so no request pays a shape's first
        call (cuBLAS heuristics, allocator growth)."""
        for b in self._bucket_sizes:
            slot = self._take_slot()
            self._dispatch(slot, np.zeros(b, np.int32), b)
            self._fetch(slot, b)

    # -- public API ----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self._bucket_sizes:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds max_batch {self.config.max_batch}")

    def _prep_ids(self, node_ids: Sequence[int]):
        """Validate and bucket-pad a request: ``(n, int32[bucket] ids)``.
        Shared by the blocking and pipelined paths, so both reject
        exactly the same inputs (engine.py:281-312)."""
        n = len(node_ids)
        arr = np.asarray(node_ids)
        # non-integer ids (JSON floats, strings) are rejected, not
        # truncated by the astype below
        if not np.issubdtype(arr.dtype, np.integer):
            if np.issubdtype(arr.dtype, np.floating) and np.all(
                    arr == np.floor(arr)):
                arr = arr.astype(np.int64)   # exact integral floats OK
            else:
                raise ValueError(
                    f"node_ids must be integers; got dtype {arr.dtype}")
        n_nodes = self._n_nodes
        if arr.size and (arr.min() < 0 or arr.max() >= n_nodes):
            bad = arr[(arr < 0) | (arr >= n_nodes)][0]
            raise ValueError(
                f"node id {int(bad)} out of range [0, {n_nodes})")
        ids = np.zeros(self.bucket_for(n), np.int32)
        ids[:n] = arr.astype(np.int32)
        return n, ids

    def predict_logits(self, node_ids: Sequence[int]) -> np.ndarray:
        """Logits for a node-id batch (padded to its bucket internally)."""
        if len(node_ids) == 0:
            return np.zeros((0, self.n_classes), np.float32)
        n, ids = self._prep_ids(node_ids)
        slot = self._take_slot()
        t0 = time.perf_counter()
        self._dispatch(slot, ids, n)
        out = self._fetch(slot, n)
        self.stats.observe(n, time.perf_counter() - t0)
        return out

    def predict_logits_stream(self, batches, depth: int = 2):
        """Pipelined inference over an iterable of id batches: yields
        numpy logits in order, with at most ``depth`` requests in flight
        (engine.py:324-346; the reference's drain keeps ``depth + 1``,
        engine.py:367). Batch k + 1's ids go up and its forward is queued
        before batch k's logits are fetched, so the host's work on one
        request overlaps the device's on another. The device work per
        request is the blocking path's, so outputs equal
        :meth:`predict_logits` bit for bit.

        The latency recorded in ``stats`` is submit -> fetch wall time,
        the in-flight queueing included.
        """
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        inflight: deque = deque()

        def fetch():
            n, t0, slot = inflight.popleft()
            if slot is None:      # an empty batch rides the queue so
                #                   results stay in submission order
                return np.zeros((0, self.n_classes), np.float32)
            out = self._fetch(slot, n)
            self.stats.observe(n, time.perf_counter() - t0)
            return out

        for node_ids in batches:
            entry = (0, 0.0, None)
            if len(node_ids):
                n, ids = self._prep_ids(node_ids)
            while len(inflight) >= depth:
                yield fetch()
            if len(node_ids):
                slot = self._take_slot()
                t0 = time.perf_counter()
                self._dispatch(slot, ids, n)
                entry = (n, t0, slot)
            inflight.append(entry)
        while inflight:
            yield fetch()

    def predict(self, node_ids: Sequence[int]) -> np.ndarray:
        """Argmax class predictions."""
        return np.argmax(self.predict_logits(node_ids),
                         axis=1).astype(np.int32)
