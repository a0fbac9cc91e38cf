"""Multi-process distributed training: launcher, worker, parity check
(the counterpart of sgc_tpu/cli/dist_demo.py).

The launcher starts ``--procs`` x ``--devices-per-proc`` ranks through
``parallel.distributed.launch``, one device each (a card each, taken in
turn, or the CPU with ``--device cpu``), over ``--transport`` (gloo by
default: the multi-process regime through the host; nccl needs a card per
rank). The world runs :func:`fit_sharded` on the reference's mesh rule
(two "feat" shards when the rank count is even and at least 4) and a
deterministic synthetic graph; then the same fit runs in a world of one
rank, a (1, 1) mesh, with the formulation the world chose, and the JSON
line reports the loss and parameter deviation between the two:

    python -m sgc_tpu_torch.cli.dist_demo --procs 2 --devices-per-proc 2

For a real multi-host run, start one worker per device with a TCP
rendezvous (each worker is one rank of ``--procs``, so
``--devices-per-proc`` must be 1):

    python -m sgc_tpu_torch.cli.dist_demo --worker --process-id <k> \\
        --procs <N> --devices-per-proc 1 --coordinator <host0>:<port> \\
        --out <file>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

# seconds a world may take before every rank is stopped (--timeout)
DEFAULT_TIMEOUT_S = 600.0


def _build_problem(seed: int, nodes: int, edges: int, features: int,
                   n_parts: int):
    """The reference's deterministic clustered graph, features, labels and
    train ids, bit for bit; identical in every process."""
    import scipy.sparse as sp

    from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
    from sgc_tpu_torch.graph.sparse import SparseGraph

    rng = np.random.default_rng(seed)
    n, e = nodes, edges
    block_size = -(-n // n_parts)
    src = rng.integers(0, n, e)
    same = rng.random(e) < 0.9
    local = (src // block_size) * block_size + (
        rng.integers(0, block_size, e)
    ) % np.maximum(
        np.minimum((src // block_size + 1) * block_size, n)
        - (src // block_size) * block_size,
        1,
    )
    dst = np.where(same, local, rng.integers(0, n, e))
    adj = sp.coo_matrix((np.ones(e, np.float32), (src, dst)), shape=(n, n))
    graph = SparseGraph.from_scipy(aug_normalized_adjacency(adj + adj.T))
    x = rng.standard_normal((n, features)).astype(np.float32)
    y = rng.integers(0, 7, n).astype(np.int32)
    idx_train = np.arange(n // 2)
    return graph, x, y, idx_train


def run_fit(cfg: dict) -> dict:
    """The fit on this world (every rank calls it): the reference's mesh
    rule over the world, or (1, 1) with ``cfg["n_parts"]`` fixing the
    problem's blocks; a JSON-able summary."""
    import torch

    from sgc_tpu_torch.parallel.fit import fit_sharded
    from sgc_tpu_torch.parallel.mesh import make_mesh

    n_total = torch.distributed.get_world_size()
    n_feat = 2 if n_total % 2 == 0 and n_total >= 4 else 1
    mesh = make_mesh(n_total // n_feat, n_feat, device=cfg.get("device"))
    n_parts = cfg.get("n_parts") or n_total // n_feat
    graph, x, y, idx_train = _build_problem(
        cfg["seed"], cfg["nodes"], cfg["edges"], cfg["features"], n_parts)
    params, report = fit_sharded(
        graph, x, y, idx_train, n_classes=7, mesh=mesh,
        epochs=cfg["epochs"], use_halo=cfg["use_halo"],
        formulation=cfg.get("formulation", "auto"))
    w = params.w.cpu().numpy()
    return {
        "process_count": n_total,
        "n_devices": mesh.size,
        "n_parts": n_parts,
        "formulation": report.formulation,
        "losses": report.loss_history,
        "train_accuracy": report.train_accuracy,
        "halo_fraction": report.halo_fraction,
        "w_sum": float(np.abs(w).sum()),
        "w_head": w[0, :4].tolist(),
        "b": params.b.cpu().numpy().tolist(),
    }


def _cfg(a) -> dict:
    return {"seed": a.seed, "nodes": a.nodes, "edges": a.edges,
            "features": a.features, "epochs": a.epochs,
            "use_halo": True if a.halo else None,
            "device": "cpu" if a.device == "cpu" else None}


def _worker(a) -> None:
    """One rank of a multi-host world, joined through ``--coordinator``."""
    import torch

    from sgc_tpu_torch.parallel.scaling import init_distributed

    if a.devices_per_proc != 1:
        raise ValueError("a worker is one rank driving one device: start "
                         "one worker per device (--devices-per-proc 1)")
    backend = a.transport
    init_distributed(init_method=f"tcp://{a.coordinator}",
                     world_size=a.procs, rank=a.process_id, backend=backend,
                     timeout_s=a.timeout)
    try:
        result = run_fit(_cfg(a))
        if torch.distributed.get_rank() == 0 and a.out:
            with open(a.out, "w") as f:
                json.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


def _launch(a) -> int:
    from sgc_tpu_torch.parallel import bodies
    from sgc_tpu_torch.parallel.distributed import launch

    ranks = a.procs * a.devices_per_proc
    cfg = _cfg(a)
    with tempfile.TemporaryDirectory(prefix="sgc_dist_") as tmp:
        dist = launch(bodies.cli_dist_demo, ranks, a.transport,
                      os.path.join(tmp, "world"), (cfg,), a.timeout)[0]
        # the same fit in a world of one rank, a (1, 1) mesh
        single = launch(bodies.cli_dist_demo, 1, a.transport,
                        os.path.join(tmp, "one"),
                        ({**cfg, "n_parts": dist["n_parts"],
                          "formulation": dist["formulation"]},),
                        a.timeout)[0]
    loss_dev = float(np.max(np.abs(np.asarray(dist["losses"])
                                   - np.asarray(single["losses"]))))
    b_dev = float(np.max(np.abs(np.asarray(dist["b"])
                                - np.asarray(single["b"]))))
    w_head_dev = float(np.max(np.abs(np.asarray(dist["w_head"])
                                     - np.asarray(single["w_head"]))))
    ok = loss_dev < 1e-4 and b_dev < 1e-4 and w_head_dev < 1e-4
    print(json.dumps({
        "ok": bool(ok),
        "procs": a.procs,
        "devices_per_proc": a.devices_per_proc,
        "global_devices": dist["n_devices"],
        "process_count_seen": dist["process_count"],
        "halo_fraction": dist["halo_fraction"],
        "final_loss": dist["losses"][-1],
        "train_accuracy": dist["train_accuracy"],
        "max_loss_deviation_vs_single_process": loss_dev,
        "max_param_deviation_vs_single_process": max(b_dev, w_head_dev),
        "formulation": dist["formulation"],
        "transport": a.transport,
        "device": "cpu" if a.device == "cpu" else "cuda",
    }))
    return 0 if ok else 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--devices-per-proc", type=int, default=4)
    p.add_argument("--nodes", type=int, default=4096)
    p.add_argument("--edges", type=int, default=40_000)
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--halo", action="store_true",
                   help="force the halo-exchange path (default: auto)")
    p.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    p.add_argument("--device", default=None,
                   help="'cpu' for CPU ranks (default: the CUDA cards)")
    p.add_argument("--transport", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.worker:
        _worker(a)
        return 0
    return _launch(a)


if __name__ == "__main__":
    sys.exit(main())
