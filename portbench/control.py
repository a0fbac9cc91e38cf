"""The readings that a cell's correctness limits are set from, at the
cell's own size, on the card.

    python3 -m portbench.control --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out file.json]

* the lower readings: the program, a run of the cell with a window of
  one step on each of ``--seeds``, its checks as a run computes them;
* the upper readings: on each of ``--control-seeds``, the control (the
  plain reference in TF32, the precision below the configuration's f32
  with TF32 off, put in the program's place) and the faults that the
  cell can have, each planted in the float64 reference put in the
  program's place, all held against the float64 reference as a run
  holds the program.

SGC faults: the head returned unchanged (its initial weights), the head
fitted on half of the train rows, one propagated row replaced by
another's. GAT faults: the parameters left unchanged by the steps, the
loss taken over half of the train rows, one train row's first-step
logits replaced by another's.

Prints one JSON object (and writes it to ``--out``): every reading, then
for each number the largest lower and the smallest upper reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import graphgen, spec
from portbench.record import log


def sgc_upper(config: dict, traffic: dict, seed: int, device) -> dict:
    from portbench.reference import sgc as ref

    task = spec.task("sgc")
    head, degree = config["head"], config["degree"]
    wd, steps = head["weight_decay"], head["steps"]
    d = graphgen.generate(config["shape"], traffic["graph"], seed)
    w0, b0 = task.init_head(seed, d.features.shape[1], d.n_classes, device)
    theta0 = torch.cat([w0, b0[None]]).double()
    labels = torch.as_tensor(d.labels[d.idx_train], device=device)
    p64 = ref.propagate(d.src, d.dst, d.n, d.features, d.idx_train, degree,
                        device)
    margins = []
    theta_ref, _ = ref.newton_head(p64, labels, theta0, wd, steps,
                                   margins=margins)
    p32 = ref.propagate(d.src, d.dst, d.n, d.features, d.idx_train, degree,
                        device, "tf32")
    theta_c, _ = ref.newton_head(p32, labels, theta0, wd, steps, "tf32")
    out = {"control": {"prop_err": task.prop_gap(p32, p64),
                       "head_err": task.head_gap(theta_c, theta_ref)}}
    del p32
    theta_h, _ = ref.newton_head(p64[::2], labels[::2], theta0, wd, steps)
    moved = p64.clone()
    moved[0] = p64[1]
    out["faults"] = {
        "unchanged": {"head_err": task.head_gap(theta0, theta_ref)},
        "half_batch": {"head_err": task.head_gap(theta_h, theta_ref)},
        "altered_row": {"prop_err": task.prop_gap(moved, p64)}}
    out["line_search_margin_min"] = min(margins)
    return out


def gat_upper(config: dict, traffic: dict, seed: int, device) -> dict:
    from portbench.reference import gat as ref

    task = spec.task("gat")
    first = traffic["first_steps"]
    d = graphgen.generate(config["shape"], traffic["graph"], seed)
    init = task.init_layers(seed, config["layers"], device)
    args = (init, d.src, d.dst, d.n, d.features, d.labels, d.idx_train,
            config["optimizer"], first, device)
    want = task.readings(ref.train(*args))
    out = {"control": task.gaps(task.readings(ref.train(*args, "tf32")),
                                want)}
    half = task.readings(ref.train(*args, half_batch=True))
    still = {"losses": [want["losses"][0]] * first, "grad1": want["grad1"],
             "change": [0.0] * len(want["change"]),
             "logits": want["logits"]}
    moved = dict(want, logits=want["logits"].clone())
    moved["logits"][0] = want["logits"][1]
    out["faults"] = {"half_batch": task.gaps(half, want),
                     "unchanged": task.gaps(still, want),
                     "altered_logits": task.gaps(moved, want)}
    return out


UPPER = {"sgc": sgc_upper, "gat": gat_upper}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
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
    result = {"workload": a.workload, "card": torch.cuda.get_device_name(0),
              "limits": config["limits"], "program": {}, "upper": {}}
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
        result["upper"][seed] = UPPER[config["model"]](config, traffic, seed,
                                                       device)
        log(f"upper seed {seed}: {result['upper'][seed]} "
            f"({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    names = list(config["limits"])
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
