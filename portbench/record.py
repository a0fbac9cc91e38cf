"""What one run of a cell leaves for the metric readers, and the steps
of a closed loop that fill it."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # False for NaN


@dataclasses.dataclass
class RunRecord:
    """One run of one cell.

    ``step_ms``: each timed step's time from CUDA events at its start and
    after its closing synchronize. ``spans``: with tracing, each step's
    phases (ms, from CUDA events at the phase boundaries), by phase name.
    ``counts``: the work of one step, counted by the benchmark from its
    own inputs. ``trace``: the profiler window's summary (trace.py).
    """

    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    step_ms: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    setup_spans: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    checks: list = dataclasses.field(default_factory=list)
    failed: int = 0
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


class Phases:
    """The ``phase(name)`` context that a step wraps around its parts:
    with ``events``, a CUDA event closes each phase (the spans of
    :class:`RunRecord`); with ``annotate``, each phase is a profiler
    range of that name; otherwise it does nothing."""

    def __init__(self, events: bool = False, annotate: bool = False):
        self.events, self.annotate = events, annotate
        self.marks: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.annotate:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        if self.events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))


def release_program(device) -> None:
    """Drop the program's placed layouts and cached device blocks, so
    that the reference runs with the program's state freed."""
    from sgc_tpu_torch.utils.buildcache import clear_placed

    clear_placed()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def timed_loop(step, seconds: float, rec: RunRecord, device,
               events: bool = False) -> None:
    """Run ``step(phase)`` in a closed loop until ``seconds`` have passed
    on the host clock, each step closed by a synchronize, and fill
    ``rec``'s window, steps, ``step_ms`` and (with ``events``) spans."""
    if device.type != "cuda":
        return _cpu_loop(step, seconds, rec)
    pairs, marks = [], []
    t0 = time.perf_counter()
    while True:
        phase = Phases(events=events)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(phase)
        end.record()
        end.synchronize()
        pairs.append((start, end))
        marks.append(phase.marks)
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    rec.steps = len(pairs)
    rec.step_ms = [s.elapsed_time(e) for s, e in pairs]
    for (start, _), step_marks in zip(pairs, marks):
        prev = start
        for name, ev in step_marks:
            rec.spans.setdefault(name, []).append(prev.elapsed_time(ev))
            prev = ev


def _cpu_loop(step, seconds: float, rec: RunRecord) -> None:
    """The loop on the CPU (the tests'): host-clock steps, no spans."""
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        step(Phases())
        rec.step_ms.append((time.perf_counter() - s) * 1e3)
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    rec.steps = len(rec.step_ms)
