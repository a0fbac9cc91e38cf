"""What the program recorded about itself in the profiled window: the
spans and counters of ``sgc_tpu_torch.utils.profiling`` (its recorder is
on exactly while a ``torch.profiler`` session runs, so here while
``trace.profile_steps`` runs), per traced step.

Each reader returns None where there is nothing to read: no profiled
window, a program without the recorder, or no such span or counter in
the window.
"""

from __future__ import annotations


def summary() -> dict | None:
    """The recorder's ``trace_summary()``, or None where the program has
    no recorder."""
    try:
        from sgc_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "trace_summary", None)
    return read() if read is not None else None


def _steps(run) -> int | None:
    t = run.trace
    return t["steps"] if t and t.get("steps") else None


def span_ms(run, name: str) -> float | None:
    """The device ms of the spans ``name`` over the window, per traced
    step."""
    steps = _steps(run)
    s = summary() if steps else None
    entry = s["spans"].get(name) if s else None
    if not entry or entry["device_ms"] is None:
        return None
    return entry["device_ms"] / steps


def count(run, prefix: str) -> float | None:
    """The windowed total of the counter ``prefix``, or of every counter
    whose name starts with ``prefix`` when it ends in a dot, per traced
    step."""
    steps = _steps(run)
    s = summary() if steps else None
    if not s:
        return None
    if prefix.endswith("."):
        found = [n for k, n in s["counts"].items() if k.startswith(prefix)]
    else:
        found = [s["counts"][prefix]] if prefix in s["counts"] else []
    return sum(found) / steps if found else None
