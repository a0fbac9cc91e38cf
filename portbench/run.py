"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Reads ``BENCHMARK.json``, finds the cell's configuration, traffic mix,
system under test and metrics by name (spec.py), runs set-up, a closed
loop of ``--seconds`` and, with ``--trace 1``, a short profiled window
after it; then frees the program's state and holds what the timed path
produced against the plain reference. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the checks are also the last lines
of standard error.

Exits non-zero with no result line when there is no CUDA device or
fewer than the cell asks for, and when the process holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# top-level module names the measured process must not hold: JAX and
# the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "sgc_tpu")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``sgc_tpu_torch`` is not ``sgc_tpu``)."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(bench, cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device,
             process_start: float = PROCESS_START) -> dict:
    """Run ``cell`` and return its result line as a dict."""
    import torch

    from portbench import spec
    from portbench import trace as tr

    task = spec.task_for(config, traffic)
    rec = task.run(config, traffic, seed, seconds, trace, device,
                   process_start)
    metrics = {}
    chosen = bench.per_layer(cell["name"]) if trace \
        else bench.end_to_end(cell["name"])
    for m in chosen:
        value = spec.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(rec.memory_peak_bytes)}
    line = {"correct": rec.correct, "attempted": rec.steps,
            "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        line["breakdown"] = tr.breakdown(rec.trace)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in rec.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import spec

    bench = spec.Benchmark()
    cell = bench.workload(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: nothing measured")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell['chips']}: nothing measured")
        return 2
    line = run_cell(bench, cell, bench.config(cell["config"]),
                    bench.traffic(cell["traffic"]), args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0))
    held = forbidden_modules()
    if held:
        log(f"the process holds {held}: no result")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
