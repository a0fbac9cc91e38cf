"""A short steady window under ``torch.profiler`` and its reduction: the
device's busy time (the union of kernel, copy and memset intervals),
the window's length, device time by kernel name, and the idle gaps named
by what the host was doing in them."""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120


def profile_steps(step, n_steps: int, phase_factory) -> dict:
    """``n_steps`` of ``step(phase)``, each in a ``step`` range and closed
    by a synchronize, under the profiler; the window's summary."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(n_steps):
            with record_function("step"):
                step(phase_factory())
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, n_steps)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, n_steps: int) -> dict:
    """Reduce chrome-trace events (times in us) of ``n_steps`` steps."""
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "step"
             and "dur" in e]
    if not steps:
        return {"steps": n_steps, "window_s": 0.0, "busy_s": 0.0,
                "kernels": {}, "idle": {}}
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    device, kernels = [], {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if t > s:
                device.append((s, t))
                name = e["name"][:NAME_CHARS]
                kernels[name] = kernels.get(name, 0.0) + (t - s) * 1e-6
    busy = _union(device)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in HOST_CATS and "dur" in e
            and e["name"] != "step"]
    host = (np.array([h[0] for h in host], dtype=np.float64),
            np.array([h[1] for h in host], dtype=np.float64),
            [h[2] for h in host])
    idle = {}
    prev = w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            label = _host_at((prev + s) / 2, host)
            idle[label] = idle.get(label, 0.0) + (s - prev) * 1e-6
        prev = max(prev, t)
    return {"steps": n_steps, "window_s": (w1 - w0) * 1e-6,
            "busy_s": busy_s, "kernels": kernels, "idle": idle}


def _host_at(t: float, host) -> str:
    """The host's two innermost ranges open at time ``t`` (below the
    step), outer first, joined by ``/``."""
    starts, ends, names = host
    at = np.nonzero((starts <= t) & (ends >= t))[0]
    at = at[np.argsort(starts[at] - ends[at], kind="stable")][-2:]
    return "/".join(names[i][:NAME_CHARS // 2] for i in at) or "host idle"


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time, and the ten largest idle shares by host activity, in
    seconds over the traced window."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]
    return {"device_ops": top(summary["kernels"]),
            "idle_gaps": top(summary["idle"])}


def kernel_seconds(summary: dict | None, needle: str) -> float | None:
    """Device seconds of the kernels whose name holds ``needle``, per
    traced step; None without a trace or such a kernel."""
    if not summary:
        return None
    total = sum(v for k, v in summary["kernels"].items() if needle in k)
    return total / summary["steps"] if total > 0 else None


def idle_percent(summary: dict | None) -> float | None:
    """The traced window's share with no device operation, in %."""
    if not summary or summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
