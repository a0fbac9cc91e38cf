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
* The recorder of spans and counters:

  - ``span(name, device)`` marks a layer's work. Tracing is on exactly
    while a ``torch.profiler`` session is active; off, a span is one
    check of the profiler's flag and a shared do-nothing object. On, it
    opens a ``record_function`` range of its name (so the profiler's
    Chrome trace shows it beside its kernels) and keeps its parent (the
    span open on this thread), its host start and end
    (``perf_counter_ns``) and, on a CUDA device, a pair of CUDA events
    on the current stream. Nothing synchronizes until the summary is
    read.
  - ``count(name, n)`` adds to an always-on total, and while tracing is
    on to a windowed total too. Every hand-kernel launch is counted
    once as ``launch.<C entry>``; sub-counts of launches counted there
    take ``within.<...>`` (:class:`within`); ``host_sync`` counts the
    host's blocks on a CUDA device (:func:`host_sync`, :func:`sync`).
  - ``read_counts`` / ``zero_counts`` read and clear the always-on
    totals; ``trace_summary`` / ``reset_trace`` read and clear what was
    recorded while tracing was on.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

# the recorder's state: counters always on and in the traced window,
# the spans closed while tracing was on, and each thread's open spans
_COUNTS: collections.Counter = collections.Counter()
_WINDOW: collections.Counter = collections.Counter()
_SPANS: list = []
_OPEN = threading.local()
# counter name -> the sub-counts open on it (class within)
_WITHIN: dict = {}


class _Off:
    """The span while tracing is off: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One span recorded while tracing is on (see :func:`span`)."""

    __slots__ = ("name", "parent", "t0", "t1", "events", "_range")

    def __init__(self, name: str, device):
        self.name = name
        self.parent = None
        self.t0 = self.t1 = 0
        self.events = None
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True),
                           torch.cuda.current_stream(device))
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._range.__enter__()
        if self.events is not None:
            self.events[0].record(self.events[2])
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.events[2])
        self._range.__exit__(exc_type, exc, tb)
        _OPEN.stack.pop()
        _SPANS.append(self)
        return False

    def device_ms(self) -> float | None:
        """The span's device time from its event pair (waits for the
        end event); None off a CUDA device."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


def span(name: str, device=None):
    """A context manager that marks a layer's work on ``device`` (CUDA
    events are recorded only on a CUDA device). While tracing is off it
    costs one check of the profiler's flag and returns a shared object
    that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``: to its always-on total, and while
    tracing is on to its windowed total; likewise to every sub-count
    that an open :class:`within` adds to ``name``."""
    _COUNTS[name] += n
    if _autograd_profiler._is_profiler_enabled:
        _WINDOW[name] += n
    if _WITHIN:
        for sub in _WITHIN.get(name, ()):
            _COUNTS[sub] += n
            if _autograd_profiler._is_profiler_enabled:
                _WINDOW[sub] += n


class within:
    """While open, each count of a counter that ``subs`` names counts
    also as its sub-count: ``within({"launch.csr_spmm":
    "within.csr_spmm_transposed"})`` around the products over a
    transpose."""

    __slots__ = ("subs",)

    def __init__(self, subs: dict):
        self.subs = subs

    def __enter__(self):
        for name, sub in self.subs.items():
            _WITHIN.setdefault(name, []).append(sub)
        return self

    def __exit__(self, *exc):
        for name, sub in self.subs.items():
            open_subs = _WITHIN[name]
            open_subs.remove(sub)
            if not open_subs:
                del _WITHIN[name]
        return False


def host_sync(device, n: int = 1) -> None:
    """Count ``n`` blocks of the host on ``device`` under ``host_sync``:
    a read of a device value (``float()``, ``.item()``, indexing with a
    0-d device tensor), a library call that reads an error flag back, a
    copy from pageable host memory, a synchronize. Counts only on a
    CUDA device, where the host waits."""
    if torch.device(device).type == "cuda":
        count("host_sync", n)


def read_counts(names=None) -> dict:
    """The always-on totals: every counter, or those ``names`` gives (a
    list of counter names, or a mapping of labels to counter names,
    keyed then by label); a counter never counted reads 0."""
    if names is None:
        return dict(_COUNTS)
    if isinstance(names, dict):
        return {label: _COUNTS[c] for label, c in names.items()}
    return {c: _COUNTS[c] for c in names}


def zero_counts() -> None:
    """Clear the always-on totals (the windowed ones stay)."""
    _COUNTS.clear()


def recorded_spans() -> list:
    """The spans closed while tracing was on, in the order they closed
    (each with ``name``, ``parent`` span, ``t0`` / ``t1`` in host ns,
    ``host_ms`` and ``device_ms()``)."""
    return list(_SPANS)


def trace_summary() -> dict:
    """What was recorded while tracing was on: ``spans``, per name the
    number of spans, their device ms (the sum of their event pairs; None
    where none ran on a CUDA device) and host ms; ``counts``, per
    counter the windowed total. Waits for the spans' end events."""
    spans: dict = {}
    for s in _SPANS:
        e = spans.setdefault(s.name, {"count": 0, "device_ms": None,
                                      "host_ms": 0.0})
        e["count"] += 1
        e["host_ms"] += s.host_ms
        ms = s.device_ms()
        if ms is not None:
            e["device_ms"] = (e["device_ms"] or 0.0) + ms
    return {"spans": spans, "counts": dict(_WINDOW)}


def reset_trace() -> None:
    """Clear the spans and the windowed counts."""
    _SPANS.clear()
    _WINDOW.clear()


def sync(device=None) -> None:
    """Wait for every queued kernel on ``device`` (a no-op on the CPU),
    so a host clock read after it closes the timed work; counted as a
    ``host_sync`` on a card."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(dev)
            count("host_sync")


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
