"""Features larger than one device (the counterpart of
scripts/exp_beyond_device.py).

Builds the reference's synthetic clustered graph (97% of the edges inside
contiguous row blocks) with a planted class signal in the features, and
fits the SGC head with ``fit_sharded`` (segment hops through the halo
exchange, in feature-column panels and edge chunks) over the world
``parallel.distributed.cli_world`` starts: one NCCL rank per card, or
with ``--device cpu`` the gloo ranks ``SGC_TPU_TORCH_CPU_RANKS`` names
(the counterpart of the reference's 8-device virtual CPU mesh). Each rank
stages only its own rows from the row provider
(``parallel/staging.py``), so the full feature matrix exists in no single
buffer, host or device.

The reference's defaults, 2.4M nodes x 2,048 f32 features (19.7 GB),
exceed one TPU v5e's 16 GiB of HBM, which is what it set out to show.
They fit in one H100's 80 GB. So the JSON states both, each under its own
name: ``exceeds_v5e_hbm`` against the TPU's capacity
(``staging.V5E_HBM_BYTES``, a TPU figure), and ``exceeds_device_memory``
against the memory of each rank's own device, from
``staging.sharding_report`` (None on the CPU, which has no device
memory to exceed). A run shows a matrix larger than one device only
where ``exceeds_device_memory`` is true.

Knobs, the reference's: ``SGC_BEYOND_SCALE`` (default 1.0; below 1 the
node count scales, with a 4,096 floor, and so does the feature count,
with a 64 floor), ``SGC_BEYOND_EPOCHS`` (5) and ``SGC_BEYOND_TRACE_RSS``
(log each rank's resident set as it climbs).

    SGC_BEYOND_SCALE=0.05 python -m sgc_tpu_torch.scripts.exp_beyond_device
        [--device cuda|cpu]

On the host of one card the defaults take ~40 GB (the provider's block
and the staged tile) on top of the graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import resource
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.parallel.staging import V5E_HBM_BYTES, synthetic_features
from sgc_tpu_torch.scripts import backend, device_parser, log
from sgc_tpu_torch.utils.device import resolve_device

# defaults chosen by the reference so that the features alone
# (N * F * 4 bytes) exceed one TPU v5e's 16 GiB
N_NODES = 2_400_000
N_FEATURES = 2_048
N_CLASSES = 16
AVG_DEGREE = 4
# the graph's row blocks (the reference's mesh size), whatever the world
GRAPH_BLOCKS = 8
EDGE_CHUNK = 262_144
# rows of the provider's block computed at a time (bounds the hash's
# uint64 temporaries; the values do not depend on it)
PROVIDER_ROWS = 1 << 16
TIMEOUT_S = 3600.0


def rss_gib() -> float:
    """This process's peak resident set in GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def current_rss_gib() -> float:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * 4096 / 2**30


def start_rss_tracer(t_start: float, tag: str = "") -> None:
    """Log the current resident set whenever it climbs more than 0.5 GiB
    above the last report (a daemon thread)."""
    def loop():
        last = 0.0
        while True:
            c = current_rss_gib()
            if c > last + 0.5:
                log(f"[rss{tag} +{time.perf_counter() - t_start:.0f}s] "
                    f"{c:.1f} GiB")
                last = c
            time.sleep(0.25)

    threading.Thread(target=loop, daemon=True).start()


class class_signal_features:
    """The reference's provider: ``synthetic_features`` rows plus a planted
    class signal. Node i's class is its contiguous id block; columns
    [class * 8, class * 8 + 8) get +0.75, so the propagated linear head
    has something to learn. Bit for bit the reference's rows, computed
    ``PROVIDER_ROWS`` rows at a time."""

    def __init__(self, n_rows: int, n_cols: int, n_classes: int,
                 seed: int = 0):
        self._base = synthetic_features(n_rows, n_cols, seed=seed)
        self.shape = self._base.shape
        self.dtype = self._base.dtype
        self.n_classes = n_classes

    def labels(self, start: int, stop: int) -> np.ndarray:
        return ((np.arange(start, stop, dtype=np.int64) * self.n_classes)
                // self.shape[0]).astype(np.int32)

    def __call__(self, start: int, stop: int) -> np.ndarray:
        out = np.empty((stop - start, self.shape[1]), self.dtype)
        for s in range(start, stop, PROVIDER_ROWS):
            e = min(s + PROVIDER_ROWS, stop)
            x = self._base(s, e)
            y = self.labels(s, e)
            cols = (y[:, None] * 8 + np.arange(8)[None, :]) % self.shape[1]
            np.put_along_axis(
                x, cols, np.take_along_axis(x, cols, axis=1) + 0.75, axis=1)
            out[s - start:e - start] = x
        return out


def build_graph(n: int, avg_degree: int, n_parts: int,
                seed: int = 0) -> SparseGraph:
    """The reference's block-clustered graph: 97% of the edges inside
    contiguous row blocks of n // n_parts rows, 3% anywhere; symmetrized
    and normalized (S = (D+I)^-1/2 (A+I) (D+I)^-1/2), on the host."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree // 2
    block = n // n_parts
    src = rng.integers(0, n, size=m, dtype=np.int64)
    intra = rng.random(m) < 0.97
    off = rng.integers(1, block, size=m, dtype=np.int64)
    dst = np.where(
        intra,
        (src // block) * block + (src % block + off) % block,
        rng.integers(0, n, size=m, dtype=np.int64),
    )
    keep = src != dst
    src, dst = src[keep], dst[keep]
    adj = sp.coo_matrix(
        (np.ones(len(src), np.float32), (src, dst)), shape=(n, n))
    adj = adj + adj.T
    return SparseGraph.from_scipy(aug_normalized_adjacency(adj))


def sizes(scale: float) -> tuple[int, int]:
    """``(nodes, features)`` at ``scale``, the reference's rule."""
    n = max(int(N_NODES * scale), 4096)
    f = N_FEATURES if scale >= 1.0 else max(int(N_FEATURES * scale), 64)
    return n, f


def train_rows(n: int) -> np.ndarray:
    """The reference's train rows: a tenth of the nodes, drawn once."""
    rng = np.random.default_rng(1)
    return np.sort(rng.choice(n, max(n // 10, N_CLASSES * 4),
                              replace=False))


def col_chunk_for(f: int) -> int:
    """The reference's feature-column panel: an eighth of F, at least 128
    (its TPU's fast-gather floor, kept so the hops are the reference's)."""
    return max(f // 8, 128)


def fit_rank(root: str, cfg: dict) -> dict:
    """One rank of the fit (``parallel.distributed.launch``): the graph
    from ``root``, this rank's rows staged from the provider, then
    ``fit_sharded`` on a ``(world, 1)`` mesh. Returns the rank's timings,
    peak resident set, sharding report and kernel launches (counters
    zeroed at the start); rank 0 also the head. With ``cfg["hold"]`` every
    kernel call of the hops is held against its plain version
    (``parallel/bodies.py::hold_launches``; the plain versions count no
    launch) and ``"held"`` gives each kernel's largest error."""
    from sgc_tpu_torch.parallel import bodies
    from sgc_tpu_torch.parallel.distributed import load_host
    from sgc_tpu_torch.parallel.fit import fit_sharded, plan_fit
    from sgc_tpu_torch.parallel.mesh import make_mesh
    from sgc_tpu_torch.parallel.partition import _round_up
    from sgc_tpu_torch.parallel.staging import sharding_report
    from sgc_tpu_torch.utils.profiling import read_counts, sync, zero_counts

    graph = load_host(Path(root) / "graph")
    world = torch.distributed.get_world_size()
    mesh = make_mesh(world, 1, device=cfg["device"])
    n, f = cfg["n"], cfg["f"]
    prov = class_signal_features(n, f, N_CLASSES)
    labels = prov.labels(0, n)
    record = []
    zero_counts()
    t0 = time.perf_counter()
    if cfg["trace_rss"]:
        start_rss_tracer(t0, f" rank {mesh.rank}")
    with (bodies.hold_launches(record) if cfg.get("hold")
          else contextlib.nullcontext()):
        plan = plan_fit(graph, world, 1, f, use_halo=True,
                        formulation="segment", edge_chunk=EDGE_CHUNK,
                        col_chunk=cfg["col_chunk"])
        params, report = fit_sharded(
            graph, prov, labels, train_rows(n), N_CLASSES, mesh=mesh,
            degree=2, epochs=cfg["epochs"], lr=0.2, weight_decay=0.0,
            formulation="segment", use_halo=True, edge_chunk=EDGE_CHUNK,
            col_chunk=cfg["col_chunk"], init_state=cfg["init_state"],
            plan=plan)
    sync(mesh.device)
    fit_s = time.perf_counter() - t0
    # the staged tile's shape, measured against this rank's device
    tile = torch.empty((plan.pgraph.n_rows_padded // world,
                        _round_up(f, 8)), device="meta")
    out = {"rank": mesh.rank, "fit_s": fit_s, "peak_rss_gib": rss_gib(),
           "sharding": sharding_report(mesh, tile, mesh.device),
           "report": dataclasses.asdict(report),
           "launches": read_counts(bodies.COUNTERS),
           "held": held_errors(record)}
    if mesh.rank == 0:
        out.update(w=params.w.cpu().numpy(), b=params.b.cpu().numpy())
    return out


def held_errors(record: list) -> dict:
    """``{kernel: {"calls", "max_abs_err", "rel_err"}}`` of a
    ``hold_launches`` record (the largest errors)."""
    out = {}
    for name, abs_err, err in record:
        r = out.setdefault(name, {"calls": 0, "max_abs_err": 0.0,
                                  "rel_err": 0.0})
        r["calls"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["rel_err"] = max(r["rel_err"], err)
    return out


def run(scale: float = 1.0, epochs: int = 5, device=None,
        init_state=None, trace_rss: bool = False, hold: bool = False
        ) -> dict:
    """Build the graph, fit over the world, print and return the JSON
    (the reference's keys and the port's). ``init_state`` (the full
    arrays of ``parallel/train.py::state_arrays``) replaces the head
    drawn at seed 42; ``hold`` holds every kernel call of the ranks' hops
    against its plain version. Not printed: the fitted head under
    ``"_head"``, each rank's launches (``"_launches"``) and held errors
    (``"_held"``)."""
    from sgc_tpu_torch.parallel import distributed
    from sgc_tpu_torch.parallel.distributed import cli_world, save_host

    dev = resolve_device(device)
    ranks, transport, rank_dev = cli_world(dev)
    n, f = sizes(scale)
    feat_bytes = n * f * 4
    memory = (torch.cuda.get_device_properties(dev).total_memory
              if dev.type == "cuda" else None)
    mem_text = ("no device memory (CPU)" if memory is None else
                f"{memory / 2**30:.1f} GiB, exceeds: {feat_bytes > memory}")
    log(f"backend: {backend(dev)}; {ranks} rank(s) over {transport}")
    log(f"graph: {n} nodes, features {n}x{f} f32 = "
        f"{feat_bytes / 2**30:.1f} GiB (TPU v5e HBM = "
        f"{V5E_HBM_BYTES / 2**30:.0f} GiB, exceeds: "
        f"{feat_bytes > V5E_HBM_BYTES}; this device: {mem_text})")

    t0 = time.perf_counter()
    graph = build_graph(n, AVG_DEGREE, GRAPH_BLOCKS)
    t_graph = time.perf_counter() - t0
    n_edges = int(graph.nnz)
    log(f"graph built: {n_edges} edges ({t_graph:.0f}s), "
        f"peak rss {rss_gib():.1f} GiB")
    col_chunk = col_chunk_for(f)
    cfg = {"n": n, "f": f, "epochs": epochs, "col_chunk": col_chunk,
           "device": rank_dev, "init_state": init_state,
           "trace_rss": trace_rss, "hold": hold}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sgc_beyond_") as root:
        save_host(Path(root) / "graph", graph)
        del graph
        outs = distributed.launch(fit_rank, ranks, transport,
                                  f"{root}/init", (root, cfg), TIMEOUT_S)
    t_fit = time.perf_counter() - t0
    head, sharding = outs[0], outs[0]["sharding"]
    report = head["report"]
    peak = max(o["peak_rss_gib"] for o in outs)
    out = {
        "peak_host_rss_gib": round(peak, 1),
        "n_nodes": n,
        "n_features": f,
        "n_edges": n_edges,
        "feature_gb": round(feat_bytes / 1e9, 2),
        "feature_gib": round(feat_bytes / 2**30, 2),
        "exceeds_v5e_hbm": bool(feat_bytes > V5E_HBM_BYTES),
        "per_device_gib": round(feat_bytes / ranks / 2**30, 3),
        "working_set_gib_2hop": round(2 * feat_bytes / 2**30, 2),
        "n_devices": report["n_devices"],
        "halo_fraction": round(report["halo_fraction"], 4),
        "train_accuracy": round(report["train_accuracy"], 4),
        "epochs": epochs,
        "fit_s": round(t_fit, 1),
        "graph_build_s": round(t_graph, 1),
        "col_chunk": col_chunk,
        "edge_chunk": EDGE_CHUNK,
        "peak_over_features": round(peak / (feat_bytes / 2**30), 2),
        # the port's: the features against each rank's own device
        "device": backend(dev),
        "transport": transport,
        "device_memory_gib": (None if memory is None
                              else round(memory / 2**30, 2)),
        "exceeds_device_memory": sharding["exceeds_device_memory"],
        "fits_per_device": sharding["fits_per_device"],
        "staged_global_gb": sharding["global_gb"],
        "staged_per_device_gb": sharding["per_device_gb"],
        "rank_fit_s": [round(o["fit_s"], 2) for o in outs],
        "parent_peak_rss_gib": round(rss_gib(), 2),
    }
    print(json.dumps(out), flush=True)
    return {**out, "_head": (head["w"], head["b"], report),
            "_launches": [o["launches"] for o in outs],
            "_held": [o["held"] for o in outs]}


def main(argv=None) -> int:
    p = device_parser(__doc__)
    a = p.parse_args(argv)
    run(scale=float(os.environ.get("SGC_BEYOND_SCALE", "1.0")),
        epochs=int(os.environ.get("SGC_BEYOND_EPOCHS", "5")),
        device=a.device,
        trace_rss=bool(os.environ.get("SGC_BEYOND_TRACE_RSS")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
