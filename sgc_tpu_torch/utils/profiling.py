"""Timing, tracing and logging helpers (the counterpart of
sgc_tpu/utils/profiling.py).

* ``sync`` / ``sync_result`` close a host-clock span on the card: PyTorch
  returns before the device finishes, so a span ends with a synchronize
  of the device its output lives on.
* ``timed_runs`` / ``bench_timeit``: one warm call, then ``reps``
  sync-closed runs; ``bench_timeit`` prints the reference's min / median
  line.
* ``Metrics``: named timings (``timer`` with the ``holder.result``
  contract) and counters, ``spmm_rate``, ``report``.
* ``device_trace``: a ``torch.profiler`` window (CPU and CUDA activity)
  written as a Chrome trace under ``log_dir``.
* ``effective_bandwidth_gbs``; ``stack_sampler``, a daemon-thread sampler
  of the main thread's stack for attributing host spans.
* ``ScalarWriter`` logs scalar curves (``train_regression(writer=)``).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


def sync(device=None) -> None:
    """Wait for every queued kernel on ``device`` (a no-op on the CPU),
    so a host clock read after it closes the timed work."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(dev)


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync_result(result) -> None:
    """Wait for the devices of every tensor in ``result`` (a tensor or
    nested lists, tuples and dicts of them)."""
    for dev in {t.device for t in _tensors(result)}:
        sync(dev)


def timed_runs(fn, reps: int) -> tuple[list, object]:
    """``(seconds of each run, last output)``: one warm call, then
    ``reps`` runs, each closed by :func:`sync_result` of its output."""
    out = fn()
    sync_result(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync_result(out)
        ts.append(time.perf_counter() - t0)
    return ts, out


def bench_timeit(name: str, fn, reps: int = 5, emit=print):
    """:func:`timed_runs`, then emits ``name`` with the min and median
    milliseconds in the reference's line format. Returns the last
    output."""
    ts, out = timed_runs(fn, reps)
    emit(f"{name:32s} min {min(ts) * 1e3:7.1f} ms  "
         f"med {sorted(ts)[len(ts) // 2] * 1e3:7.1f} ms")
    return out


@dataclass
class Metrics:
    """Accumulates named timings and counters; printable / JSON-able."""

    timings: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def timer(self, name: str):
        """Time a block. Yields a holder: assign the block's output to
        ``holder.result`` and the exit waits for its device::

            with metrics.timer("precompute") as t:
                t.result = spmm(graph, x)
        """
        import types

        holder = types.SimpleNamespace(result=None)
        t0 = time.perf_counter()
        yield holder
        if holder.result is not None:
            sync_result(holder.result)
        self.timings[name] = self.timings.get(name, 0.0) + (
            time.perf_counter() - t0)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def spmm_rate(self, nnz: int, hops: int,
                  timing_key: str = "precompute") -> float:
        """Edges/s of ``hops`` SpMM passes timed under ``timing_key``."""
        t = self.timings.get(timing_key, 0.0)
        return (nnz * hops / t) if t > 0 else 0.0

    def report(self) -> dict:
        return {"timings_s": dict(self.timings),
                "counters": dict(self.counters)}

    def __str__(self) -> str:
        return json.dumps(self.report(), indent=2, default=float)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """A ``torch.profiler`` window over the block, CPU and CUDA activity
    (CUDA only where a card is present), written on exit as a Chrome
    trace ``trace.json`` under ``log_dir``. Yields the profiler (read
    ``key_averages()`` after the block); yields None and records nothing
    when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(str(out / "trace.json"))


def effective_bandwidth_gbs(bytes_moved: float, seconds: float) -> float:
    return bytes_moved / seconds / 1e9 if seconds > 0 else 0.0


class ScalarWriter:
    """Append-only scalar event log (the SummaryWriter analog): one JSON
    line per event, ``{"step", "tag", "value", "wall"}``."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"step": step, "tag": tag,
                                  "value": float(value),
                                  "wall": time.time()}) + "\n")

    def scalars(self, tag: str, values, start_step: int = 0) -> None:
        for i, v in enumerate(values):
            self.scalar(tag, v, start_step + i)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class stack_sampler:
    """Sampling profiler of the host: a daemon thread records the main
    thread's stack (12 frames deep) every ``interval`` seconds;
    ``report(top)`` gives the most common leaves (file, line, function)
    with their share of the samples. Native code called through ctypes
    releases the interpreter lock, so its Python caller is sampled."""

    def __init__(self, interval: float = 0.2):
        self.interval = interval
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = None

    def __enter__(self):
        import sys

        main_id = threading.main_thread().ident

        def run():
            while not self._stop.is_set():
                f = sys._current_frames().get(main_id)
                stack = []
                while f is not None and len(stack) < 12:
                    stack.append((f.f_code.co_filename.rsplit("/", 2)[-1],
                                  f.f_lineno, f.f_code.co_name))
                    f = f.f_back
                self.samples.append(tuple(stack))
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2.0)

    def report(self, top: int = 10) -> list:
        from collections import Counter

        leaves = Counter(s[0] for s in self.samples if s)
        total = max(len(self.samples), 1)
        return [{"where": f"{f}:{ln} {fn}", "frac": round(c / total, 3)}
                for (f, ln, fn), c in leaves.most_common(top)]
