"""The readings that a cell's correctness limits are set from, at the
cell's own size, on the card, for the cells whose task brings its own
upper readings (an ``upper(config, traffic, seed, device)`` function:
``tasks/gcnii.py``; ``tasks/sgc_uniform.py`` brings one too, read here
once its cell is in ``BENCHMARK.json``); ``portbench.control`` takes
them for the others.

    python3 -m portbench.control_cells --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out file.json]

As ``portbench.control``: the lower readings are the program's, a run of
the cell with a window of one step on each of ``--seeds``; the upper
readings, on each of ``--control-seeds``, are the task's control (the
plain reference in TF32) and faults, held against the float64 reference
as a run holds the program. The numbers are those a run checks, with the
limits it checks them against (the configuration's, over which the
traffic's ``limits`` win). Prints one JSON object (and writes it to
``--out``). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import spec
from portbench.record import log


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control_cells")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--out")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    bench = spec.Benchmark()
    cell = bench.workload(a.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    task = spec.task_for(config, traffic)
    limits = {**config["limits"], **traffic.get("limits", {})}
    result = {"workload": a.workload, "card": torch.cuda.get_device_name(0),
              "program": {}, "upper": {}}
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.perf_counter()
        rec = task.run(config, traffic, seed, 0.0, False, device,
                       time.perf_counter())
        result["program"][seed] = {c.name: c.value for c in rec.checks}
        log(f"program seed {seed}: {result['program'][seed]} "
            f"({time.perf_counter() - t0:.1f} s)")
        del rec
        torch.cuda.empty_cache()
    for seed in [int(s) for s in a.control_seeds.split(",")]:
        t0 = time.perf_counter()
        result["upper"][seed] = task.upper(config, traffic, seed, device)
        log(f"upper seed {seed}: {result['upper'][seed]} "
            f"({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    names = list(next(iter(result["program"].values())))
    result["limits"] = {n: limits[n] for n in names}
    result["lower_max"] = {n: max(r[n] for r in result["program"].values())
                           for n in names}
    result["control_min"] = {
        n: min(r["control"][n] for r in result["upper"].values())
        for n in names}
    faults = {}
    for r in result["upper"].values():
        for fault, nums in r["faults"].items():
            for n, v in nums.items():
                key = f"{fault}.{n}"
                faults[key] = min(faults.get(key, np.inf), v)
    result["fault_min"] = faults
    text = json.dumps(result)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
