"""Scaling-efficiency CLI, edges/s at 2, 4, ... ranks up to the world
(the counterpart of sgc_tpu/cli/scaling.py), on the card by default:

    python -m sgc_tpu_torch.cli.scaling --nodes 100000 --edges 2000000
    SGC_TPU_TORCH_CPU_RANKS=4 python -m sgc_tpu_torch.cli.scaling \\
        --device cpu --nodes 2000 --edges 20000 --json

The world is ``parallel.distributed.cli_world``'s (one rank per card over
NCCL; with ``--device cpu`` the gloo ranks ``SGC_TPU_TORCH_CPU_RANKS``
names), or ``--ranks`` ranks over ``--transport``: ``--ranks 4
--transport gloo`` runs four ranks on one card, their exchanges through
host memory. Each rank count runs in a world of its own
(``measure_spmm_scaling`` needs every rank in its mesh). One line per
count: the single-device rate, the sharded rate, the efficiency, the halo
fraction and the comm model (the reference's TPU fabric constants, a
model and not a measurement), each labelled with where its ranks ran.
Ranks that share a card or the host's cores give no scaling figure.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

# seconds one rank count's world may take before every rank is stopped
WORLD_TIMEOUT_S = 1800.0


def rank_counts(world: int) -> list[int]:
    """The reference's counts: 2, 4, ... below ``world``, then ``world``
    (one rank alone has no exchange to measure, unless it is the
    world)."""
    out, d = [], 2
    while d < world:
        out.append(d)
        d *= 2
    return out + [world]


def placement(n: int, device_type: str, transport: str) -> str:
    """Where ``n`` ranks ran, for the label of their line."""
    if device_type != "cuda":
        return f"{n} ranks on the CPU, {transport}"
    cards = torch.cuda.device_count()
    if n > cards:
        return (f"{n} ranks on {cards} card{'s' if cards > 1 else ''}, "
                f"{transport} over host")
    return f"{n} ranks on {n} card{'s' if n > 1 else ''}, {transport}"


def build_graph(a, n_parts: int):
    """The reference's synthetic graph (``--clustered``: 90% of the edges
    inside the source's contiguous block of ``n_parts``), normalized, and
    the features."""
    import scipy.sparse as sp

    from sgc_tpu_torch.graph.normalize import aug_normalized_adjacency
    from sgc_tpu_torch.graph.reorder import apply_order, fetch_ordering
    from sgc_tpu_torch.graph.sparse import SparseGraph

    rng = np.random.default_rng(a.seed)
    n, e = a.nodes, a.edges
    if a.clustered:
        block_size = -(-n // n_parts)
        src = rng.integers(0, n, e)
        same = rng.random(e) < 0.9
        block_start = (src // block_size) * block_size
        block_end = np.minimum(block_start + block_size, n)
        local = block_start + rng.integers(0, block_size, e) % (
            block_end - block_start)
        dst = np.where(same, local, rng.integers(0, n, e))
    else:
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
    adj = sp.coo_matrix((np.ones(e, np.float32), (src, dst)), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    if a.reorder != "none":
        order = fetch_ordering(a.reorder)(adj)
        adj, = apply_order(adj, order)
    graph = SparseGraph.from_scipy(aug_normalized_adjacency(adj))
    x = rng.standard_normal((n, a.features)).astype(np.float32)
    return graph, x


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=100_000)
    p.add_argument("--edges", type=int, default=2_000_000)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--hops", type=int, default=2)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--clustered", action="store_true",
                   help="block-clustered graph (halo exchange wins)")
    p.add_argument("--reorder", default="none",
                   choices=("none", "rcm", "bfs", "degree", "spectral"))
    p.add_argument("--json", action="store_true")
    p.add_argument("--hosts", type=int, default=1,
                   help="also print the two-level comm model for this "
                        "many hosts")
    p.add_argument("--devices-per-host", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--ranks", type=int, default=None,
                   help="largest rank count (default: the entry points' "
                        "world)")
    p.add_argument("--transport", default=None, choices=("nccl", "gloo"),
                   help="the world's backend (default: nccl on a card, "
                        "gloo on the CPU)")
    a = p.parse_args(argv)

    from sgc_tpu_torch.parallel import bodies
    from sgc_tpu_torch.parallel.distributed import (
        cli_world,
        launch,
        save_host,
    )
    from sgc_tpu_torch.parallel.scaling import comm_model_two_level

    world, backend, rank_dev = cli_world(a.device)
    world = a.ranks or world
    backend = a.transport or backend
    dev_type = "cpu" if rank_dev == "cpu" else "cuda"
    graph, x = build_graph(a, world)
    rep = None
    with tempfile.TemporaryDirectory(prefix="sgc_scaling_") as root:
        np.save(os.path.join(root, "x.npy"), x)
        save_host(os.path.join(root, "graph"), graph)
        for nd in rank_counts(world):
            out = launch(bodies.cli_scaling, nd, backend,
                         os.path.join(root, f"init{nd}"),
                         (root, {"hops": a.hops, "repeats": a.repeats,
                                 "device": rank_dev}), WORLD_TIMEOUT_S)[0]
            rep, model = out["report"], out["comm_model"]
            label = placement(nd, dev_type, backend)
            if a.json:
                print(json.dumps({
                    "devices": rep["n_devices"],
                    "single_edges_per_s": rep["single_rate"],
                    "sharded_edges_per_s": rep["sharded_rate"],
                    "efficiency": rep["efficiency"],
                    "halo_fraction": rep["halo_fraction"],
                    "plan_build_s": rep["plan_build_s"],
                    "comm_model": model,
                    "placement": label}), flush=True)
            else:
                print(
                    f"scaling ({label}): {rep['n_devices']} devices, "
                    f"{rep['edges']} edges x {rep['hops']} hops | 1-dev "
                    f"{rep['single_rate'] / 1e6:.1f} Me/s, "
                    f"{rep['n_devices']}-dev "
                    f"{rep['sharded_rate'] / 1e6:.1f} Me/s, efficiency "
                    f"{rep['efficiency']:.2%}, halo "
                    f"{rep['halo_fraction']:.2%}, plan build "
                    f"{rep['plan_build_s']:.2f}s")
                print(
                    "  comm model: halo {h} B/hop/chip, all-gather {g} "
                    "B/hop/chip, projected eff @{ici:.0f}GB/s (the "
                    "reference's TPU ICI): halo {eh:.0%} / all-gather "
                    "{ea:.0%}".format(
                        h=model["ici_bytes_per_hop_halo"],
                        g=model["ici_bytes_per_hop_allgather"],
                        ici=model["assumed_ici_gbps"],
                        eh=model["projected_efficiency_halo"],
                        ea=model["projected_efficiency_allgather"]),
                    flush=True)
    if a.hosts > 1:
        two = comm_model_two_level(graph, a.features, a.hosts,
                                   a.devices_per_host, rep["single_rate"])
        if a.json:
            print(json.dumps({"comm_model_two_level": two}))
        else:
            print(
                "two-level model ({H} hosts x {D} chips): per hop ICI {i} "
                "B/chip, DCN flat {df} B/host vs hierarchical {dh} B/host "
                "({sv:.0%} DCN saving); projected eff flat {ef:.0%} / hier "
                "{eh:.0%} (@{ici:.0f} GB/s ICI, {dcn:.1f} GB/s DCN: the "
                "reference's TPU figures)".format(
                    H=two["hosts"], D=two["devices_per_host"],
                    i=two["ici_bytes_per_hop_hier"],
                    df=two["dcn_bytes_per_hop_flat"],
                    dh=two["dcn_bytes_per_hop_hier"],
                    sv=two["dcn_saving_hier_vs_flat"],
                    ef=two["projected_efficiency_flat"],
                    eh=two["projected_efficiency_hier"],
                    ici=two["assumed_ici_gbps"],
                    dcn=two["assumed_dcn_gbps"]))


if __name__ == "__main__":
    main()
