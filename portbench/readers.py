"""What several metric readers share: means of spans and of the window.
The readers themselves are ``metrics/<name>.py``."""

from __future__ import annotations

import statistics


def window_ms(run) -> float | None:
    """The window's seconds in ms over its steps: every step and all the
    time of the window."""
    if not run.steps:
        return None
    return run.window_s * 1e3 / run.steps


def span_ms(run, name: str) -> float | None:
    """The mean of one phase's ms over the window's steps."""
    values = run.spans.get(name)
    return statistics.fmean(values) if values else None


def traced_step_s(run) -> float | None:
    """The profiled window's seconds per step."""
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return t["window_s"] / t["steps"]
