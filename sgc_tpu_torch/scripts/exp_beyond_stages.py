"""Per-stage resident set of the beyond-one-device path (the counterpart
of scripts/exp_beyond_stages.py).

Replays ``fit_sharded``'s stages one by one on the world
``parallel.distributed.cli_world`` starts (one NCCL rank per card, or
with ``--device cpu`` the ``SGC_TPU_TORCH_CPU_RANKS`` gloo ranks): the
graph (built in the parent, as ``exp_beyond_device`` builds it), then on
every rank the partition, the overlapped halo plan, this rank's rows
staged from the provider, two segment hops through the halo exchange, 5
Adam epochs of the head, the head fetched and the final logits gathered.
After each stage it prints the stage, the current resident set and the
seconds since the start, as the reference does, from rank 0, with the
largest resident set over the ranks beside it.

Knob, the reference's: ``SGC_BEYOND_SCALE`` (default 0.25).

    python -m sgc_tpu_torch.scripts.exp_beyond_stages [--device cuda|cpu]
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sgc_tpu_torch.scripts import backend, device_parser, log
from sgc_tpu_torch.scripts.exp_beyond_device import (
    AVG_DEGREE,
    GRAPH_BLOCKS,
    N_CLASSES,
    TIMEOUT_S,
    build_graph,
    class_signal_features,
    current_rss_gib,
    held_errors,
    sizes,
)
from sgc_tpu_torch.utils.device import resolve_device

EPOCHS = 5


def line(stage: str, rss: float, t: float, rss_max: float | None = None
         ) -> str:
    """The reference's line, with the ranks' largest resident set."""
    out = f"{stage:28s} rss {rss:6.2f} GiB  t+{t:5.0f}s"
    if rss_max is not None:
        out += f"  (max over ranks {rss_max:6.2f} GiB)"
    return out


def stages_rank(root: str, cfg: dict) -> dict:
    """One rank's stages: ``{"stages": [(stage, current rss GiB, seconds
    since the parent's start)], "launches", "held"}`` (as
    ``exp_beyond_device.fit_rank``: counters zeroed at the start; with
    ``cfg["hold"]`` each kernel call of the hops held against its plain
    version)."""
    from sgc_tpu_torch.parallel import bodies
    from sgc_tpu_torch.parallel.distributed import fetch_global, load_host
    from sgc_tpu_torch.parallel.halo import build_halo
    from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, make_mesh
    from sgc_tpu_torch.parallel.partition import partition_graph
    from sgc_tpu_torch.parallel.spmm import spmm_sharded
    from sgc_tpu_torch.parallel.staging import stage_rows
    from sgc_tpu_torch.parallel.train import (
        init_sharded_state,
        make_sharded_train_step,
        place_node_targets,
    )
    from sgc_tpu_torch.utils.profiling import sync

    t0 = cfg["t0"]
    out = []

    def mark(stage):
        sync(mesh.device)
        out.append((stage, current_rss_gib(), time.time() - t0))

    graph = load_host(Path(root) / "graph")
    world = torch.distributed.get_world_size()
    mesh = make_mesh(world, 1, device=cfg["device"])
    mark("mesh")
    pg = partition_graph(graph, world, device=False)
    mark("partition")
    halo = build_halo(pg, overlap=True, device=False)
    mark("halo build")
    n, f = cfg["n"], cfg["f"]
    prov = class_signal_features(n, f, N_CLASSES)
    x = stage_rows(mesh, prov, n_rows_padded=pg.n_rows_padded)
    mark(f"staged x {tuple(x.shape)}")
    record = []
    bodies.zero_counts()
    with (bodies.hold_launches(record) if cfg.get("hold")
          else contextlib.nullcontext()):
        h1 = spmm_sharded(mesh, pg, x, halo=halo)
        mark("hop1")
        h2 = spmm_sharded(mesh, pg, h1, halo=halo)
        mark("hop2")
    launches = bodies.read_counts()
    del h1, x
    labels = prov.labels(0, n)
    idx_train = np.arange(0, n, 10)
    y, m = place_node_targets(mesh, pg.n_rows_padded, labels, idx_train)
    state = init_sharded_state(mesh, torch.Generator().manual_seed(0),
                               int(h2.shape[1]), N_CLASSES)
    step = make_sharded_train_step(mesh, pg, degree=0, lr=0.2,
                                   weight_decay=0.0)
    for _ in range(EPOCHS):
        state, loss = step(state, h2, y, m)
    mark(f"{EPOCHS} head epochs")
    w = fetch_global(mesh, state.params.w.detach(), (FEAT_AXIS, None))
    b = state.params.b.detach().cpu().numpy()
    mark("fetch params")
    with torch.no_grad():
        logits = h2 @ torch.as_tensor(w, device=h2.device) + torch.as_tensor(
            b, device=h2.device)
    full = fetch_global(mesh, logits, (NODES_AXIS, None))
    mark(f"final logits {full.shape}")
    return {"stages": out, "launches": launches,
            "held": held_errors(record)}


def run(scale: float = 0.25, device=None, hold: bool = False) -> dict:
    """Build the graph, run the stages on every rank (``hold``: each
    kernel call of the hops held against its plain version), print rank
    0's lines; returns ``{"rows": [(stage, rank 0's rss, t, max rss over
    ranks)], "launches": each rank's, "held": each rank's}``."""
    from sgc_tpu_torch.parallel import distributed
    from sgc_tpu_torch.parallel.distributed import cli_world, save_host

    dev = resolve_device(device)
    ranks, transport, rank_dev = cli_world(dev)
    log(f"backend: {backend(dev)}; {ranks} rank(s) over {transport}")
    n, f = sizes(scale)
    t0 = time.time()
    rows = [("start", current_rss_gib(), 0.0, None)]
    print(line(*rows[-1]), flush=True)
    graph = build_graph(n, AVG_DEGREE, GRAPH_BLOCKS)
    rows.append((f"graph ({graph.nnz} edges)", current_rss_gib(),
                 time.time() - t0, None))
    print(line(*rows[-1]), flush=True)
    cfg = {"n": n, "f": f, "device": rank_dev, "t0": t0, "hold": hold}
    with tempfile.TemporaryDirectory(prefix="sgc_beyond_stages_") as root:
        save_host(Path(root) / "graph", graph)
        del graph
        outs = distributed.launch(stages_rank, ranks, transport,
                                  f"{root}/init", (root, cfg), TIMEOUT_S)
    for k, (stage, rss, t) in enumerate(outs[0]["stages"]):
        rows.append((stage, rss, t, max(o["stages"][k][1] for o in outs)))
        print(line(*rows[-1]), flush=True)
    return {"rows": rows, "launches": [o["launches"] for o in outs],
            "held": [o["held"] for o in outs]}


def main(argv=None) -> int:
    a = device_parser(__doc__).parse_args(argv)
    run(float(os.environ.get("SGC_BEYOND_SCALE", "0.25")), a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
