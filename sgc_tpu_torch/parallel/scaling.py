"""Process-group bring-up, the host-only communication models and the
edges/s scaling harness (the counterpart of sgc_tpu/parallel/scaling.py).

* :func:`init_distributed` -- ``torch.distributed`` bring-up; a no-op
  (False) for a single-process run with no rendezvous in the
  environment; a real bring-up failure raises.
* :func:`comm_model`, :func:`halo_width_model`, :func:`comm_sweep`,
  :func:`comm_model_two_level` -- host arithmetic over the partition and
  halo plans, returning the reference's dicts. Their fabric constants
  (``V5E_ICI_GBPS``, ``V5E_DCN_GBPS``) are the reference's TPU v5e
  figures, kept for parity: they say nothing about an H100 or NVLink.
* :func:`measure_spmm_scaling` -- K hops on one device (kernel B over
  the whole graph) against the same hops sharded over an n-rank
  "nodes" mesh (halo exchange), as edges/s and ``rate_n / (n *
  rate_1)``. Every rank of the world calls it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops.spmm import spmm_segment
from sgc_tpu_torch.parallel.halo import (
    HALO_PAD,
    build_halo,
    halo_fraction,
    halo_stats,
    host_union_widths,
    pair_width_matrix,
)
from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, make_mesh
from sgc_tpu_torch.parallel.partition import (
    _round_up,
    pad_node_rows,
    partition_graph,
)
from sgc_tpu_torch.parallel.spmm import propagate_sharded, shard_features
from sgc_tpu_torch.utils.profiling import sync

# the variables torchrun exports; a bare single-process run has neither
RENDEZVOUS_ENV = ("RANK", "WORLD_SIZE")


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = 600.0) -> bool:
    """Initialize the default process group.

    Returns True when a multi-rank group is up (or already was), False
    for a single-process run: no argument given and neither ``RANK`` nor
    ``WORLD_SIZE`` in the environment. ``init_method`` defaults to
    ``env://`` (torchrun's variables); ``backend`` (``"nccl"`` or
    ``"gloo"``) must be named. A bring-up failure (a bad store, an
    unreachable peer, a timeout) raises: it never degrades into a
    single-process run.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if (init_method is None and world_size is None and rank is None
            and not any(k in os.environ for k in RENDEZVOUS_ENV)):
        return False
    if backend is None:
        raise ValueError("name the backend: 'nccl' or 'gloo'")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


@dataclasses.dataclass
class ScalingReport:
    n_devices: int
    edges: int
    hops: int
    single_rate: float        # edges/s, 1 device
    sharded_rate: float       # edges/s, n ranks (the slowest rank's time)
    efficiency: float         # sharded_rate / (n * single_rate)
    halo_fraction: float      # fraction of columns needing exchange
    plan_build_s: float = 0.0  # host time to partition + build the plan

    def __str__(self) -> str:
        return (
            f"scaling: {self.n_devices} devices, {self.edges} edges x "
            f"{self.hops} hops | 1-dev {self.single_rate/1e6:.1f} Me/s, "
            f"{self.n_devices}-dev {self.sharded_rate/1e6:.1f} Me/s, "
            f"efficiency {self.efficiency:.2%}, halo "
            f"{self.halo_fraction:.2%}, plan build {self.plan_build_s:.2f}s"
        )


# The reference's TPU v5e fabric figures (GB/s per chip over ICI, per host
# over DCN), MODEL constants of its projections; kept so the models give
# the reference's numbers. Not figures of the H100 or NVLink.
V5E_ICI_GBPS = 180.0
V5E_DCN_GBPS = 12.5


def comm_model(
    graph: SparseGraph,
    feature_dim: int,
    n_devices: int,
    single_rate_edges_s: float,
    bytes_per_elem: int = 4,
    ici_gbps: float = V5E_ICI_GBPS,
    build_plan: bool = True,
) -> dict:
    """Per-hop exchange bytes and projected n-device scaling efficiency
    from a measured single-device edge rate (host arithmetic):

        t_local = (E / N) / single_rate
        t_comm  = bytes_per_device / fabric_bw
        eff     = t_local / max(t_local, t_comm)   (full overlap)

    ``build_plan=False`` sizes H from the pair widths alone (the same
    numbers for less host time).
    """
    t0 = time.perf_counter()
    pgraph = partition_graph(graph, n_devices, device=False)
    if build_plan:
        H = build_halo(pgraph, device=False).halo_width
    else:
        H = _round_up(max(halo_stats(pgraph)["max_pair_width"], 1),
                      HALO_PAD)
    plan_build_s = time.perf_counter() - t0

    P = n_devices
    F = feature_dim
    # all_to_all: (P-1) blocks of H rows each way; one direction counted
    halo_bytes = (P - 1) * H * F * bytes_per_elem
    # all-gather: every other part's row block
    n_pad = pgraph.n_rows_padded
    allgather_bytes = (n_pad - n_pad // P) * F * bytes_per_elem

    ici_bw = ici_gbps * 1e9
    t_local = (graph.nnz / P) / max(single_rate_edges_s, 1.0)
    t_halo = halo_bytes / ici_bw
    t_ag = allgather_bytes / ici_bw

    def eff(t_comm: float) -> float:
        return t_local / max(t_local, t_comm)

    return {
        "devices": P,
        "halo_width": H,
        "halo_fraction": round(P * H / pgraph.n_rows_padded, 4),
        "plan_build_s": round(plan_build_s, 3),
        "ici_bytes_per_hop_halo": int(halo_bytes),
        "ici_bytes_per_hop_allgather": int(allgather_bytes),
        "assumed_ici_gbps": ici_gbps,
        "projected_efficiency_halo": round(eff(t_halo), 4),
        "projected_efficiency_allgather": round(eff(t_ag), 4),
    }


def halo_width_model(graph: SparseGraph, n_parts: int,
                     row_align: int = 8) -> tuple[int, int]:
    """(halo width H, padded row count) of a P-part row-block partition,
    straight from the COO edge list (no ``[P, E_max]`` partition), equal
    to ``build_halo(partition_graph(g, P)).halo_width``."""
    P = n_parts
    R = _round_up(-(-graph.n_rows // P), row_align)
    rows = host(graph.rows)[: graph.nnz].astype(np.int64)
    cols = host(graph.cols)[: graph.nnz].astype(np.int64)
    vals = host(graph.vals)[: graph.nnz]
    dst = np.minimum(rows // R, P - 1)
    src = np.minimum(cols // R, P - 1)
    remote = (vals != 0) & (src != dst)
    ncp = np.int64(P) * R
    key = (dst[remote] * P + src[remote]) * ncp + cols[remote]
    if not len(key):
        return HALO_PAD, P * R
    pair = np.unique(key) // ncp
    h_max = int(np.bincount(pair, minlength=P * P).max())
    return _round_up(max(h_max, 1), HALO_PAD), P * R


def comm_sweep(
    graph: SparseGraph,
    feature_dim: int,
    single_rate_edges_s: float,
    device_counts: tuple = (8, 16, 32, 64),
    fabrics: dict | None = None,
    bytes_per_elem: int = 4,
    target: float = 0.8,
) -> dict:
    """Device-count x fabric sweep of the projected efficiency of both
    exchanges (the :func:`comm_model` overlap model); ``first_below_
    target`` is the first (fabric-major, devices ascending)
    configuration where even the better exchange drops under
    ``target``. Fabrics default to the reference's {"ici": 180, "dcn":
    25} GB/s (TPU figures)."""
    if fabrics is None:
        fabrics = {"ici": V5E_ICI_GBPS, "dcn": 25.0}
    E = graph.nnz
    F = feature_dim
    rows = []
    first_below = None
    widths = {P: halo_width_model(graph, P) for P in device_counts}
    for fabric, gbps in fabrics.items():
        bw = gbps * 1e9
        for P in device_counts:
            H, n_pad = widths[P]
            halo_bytes = (P - 1) * H * F * bytes_per_elem
            ag_bytes = (n_pad - n_pad // P) * F * bytes_per_elem
            t_local = (E / P) / max(single_rate_edges_s, 1.0)
            eff_halo = t_local / max(t_local, halo_bytes / bw)
            eff_ag = t_local / max(t_local, ag_bytes / bw)
            winner = "halo" if eff_halo >= eff_ag else "all_gather"
            rows.append({
                "devices": P,
                "fabric": fabric,
                "gbps": gbps,
                "halo_width": H,
                "ici_bytes_per_hop_halo": int(halo_bytes),
                "ici_bytes_per_hop_allgather": int(ag_bytes),
                "efficiency_halo": round(eff_halo, 4),
                "efficiency_allgather": round(eff_ag, 4),
                "winner": winner,
            })
            if first_below is None and max(eff_halo, eff_ag) < target:
                first_below = {
                    "devices": P,
                    "fabric": fabric,
                    "gbps": gbps,
                    "efficiency": round(max(eff_halo, eff_ag), 4),
                    "winner": winner,
                }
    return {
        "rate_edges_per_s": single_rate_edges_s,
        "feature_dim": F,
        "target": target,
        "rows": rows,
        "first_below_target": first_below,
    }


def comm_model_two_level(
    graph: SparseGraph,
    feature_dim: int,
    n_hosts: int,
    devices_per_host: int,
    single_rate_edges_s: float,
    bytes_per_elem: int = 4,
    ici_gbps: float = V5E_ICI_GBPS,
    dcn_gbps: float = V5E_DCN_GBPS,
) -> dict:
    """Two-fabric (within host, across hosts) halo-traffic model of a P =
    n_hosts * devices_per_host partition (contiguous parts per host),
    both transfers overlapped: ``eff = t_local / max(t_local, t_ici,
    t_dcn)``. ``ici_bytes_*`` are per device per hop, ``dcn_bytes_*``
    per host per hop; ``flat`` is the uniform all_to_all, ``hier`` sends
    each needed row across hosts once per destination host."""
    P = n_hosts * devices_per_host
    D = devices_per_host
    F = feature_dim
    t0 = time.perf_counter()
    pgraph = partition_graph(graph, P, device=False)
    W = pair_width_matrix(pgraph)                      # [P, P]
    U = host_union_widths(pgraph, n_hosts)             # [n_hosts, P]
    plan_build_s = time.perf_counter() - t0

    H = _round_up(max(int(W.max()), 1), HALO_PAD)
    part_host = np.arange(P) // D
    same_host = part_host[:, None] == part_host[None, :]
    off_diag = ~np.eye(P, dtype=bool)

    n_ici_pairs = int((same_host & off_diag).sum(axis=1).max())
    dcn_pairs_per_host = (~same_host).sum(axis=1).reshape(n_hosts, D)
    n_dcn_pairs = int(dcn_pairs_per_host.sum(axis=1).max())
    ici_flat = n_ici_pairs * H * F * bytes_per_elem
    dcn_flat = n_dcn_pairs * H * F * bytes_per_elem

    remote_src = part_host[None, :P] != np.arange(n_hosts)[:, None]
    dcn_rows_per_host = (U * remote_src).sum(axis=1)
    dcn_hier = int(dcn_rows_per_host.max()) * F * bytes_per_elem
    ici_rows_per_chip = (W * (same_host & off_diag)).sum(axis=1)
    ici_hier = int(ici_rows_per_chip.max()) * F * bytes_per_elem

    t_local = (graph.nnz / P) / max(single_rate_edges_s, 1.0)

    def eff(ici_bytes: float, dcn_bytes: float) -> float:
        t_ici = ici_bytes / (ici_gbps * 1e9)
        t_dcn = dcn_bytes / (dcn_gbps * 1e9)
        return t_local / max(t_local, t_ici, t_dcn)

    return {
        "hosts": n_hosts,
        "devices_per_host": D,
        "devices": P,
        "halo_width": H,
        "plan_build_s": round(plan_build_s, 3),
        "ici_bytes_per_hop_flat": int(ici_flat),
        "dcn_bytes_per_hop_flat": int(dcn_flat),
        "ici_bytes_per_hop_hier": int(ici_hier),
        "dcn_bytes_per_hop_hier": int(dcn_hier),
        "dcn_saving_hier_vs_flat": round(
            1.0 - dcn_hier / dcn_flat, 4
        ) if dcn_flat else 0.0,
        "assumed_ici_gbps": ici_gbps,
        "assumed_dcn_gbps": dcn_gbps,
        "projected_efficiency_flat": round(eff(ici_flat, dcn_flat), 4),
        "projected_efficiency_hier": round(eff(ici_hier, dcn_hier), 4),
    }


def measure_spmm_scaling(
    graph: SparseGraph,
    features: np.ndarray,
    n_devices: int | None = None,
    hops: int = 2,
    repeats: int = 3,
    device=None,
    transport: str | None = None,
) -> ScalingReport:
    """Edges/s on one device against an n-rank "nodes" mesh (halo
    exchange); every rank of the world calls it with the same full host
    ``graph`` and ``features`` and gets the same report.

    The first rank times the single-device hops (kernel B over the whole
    graph) while the others wait; then every rank builds the partition
    and halo plan (``plan_build_s``, the slowest rank's) and runs the
    sharded hops. The sharded rate is the slowest rank's.
    ``device`` / ``transport`` as in ``make_mesh``.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    mesh = make_mesh(n_devices, 1, device=device, transport=transport)
    if mesh is None:
        raise ValueError(f"measure_spmm_scaling on {n_devices} ranks needs "
                         "every rank of the world in its mesh")
    dev = mesh.device
    x = np.asarray(features, np.float32)

    t_single = torch.zeros((), dtype=torch.float64, device=dev)
    if mesh.rank == 0:
        g, xt = graph.to(dev), torch.as_tensor(x, device=dev)

        def single():
            y = xt
            for _ in range(hops):
                y = spmm_segment(g, y)
            return y

        single()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            single()
        sync(dev)
        t_single.fill_((time.perf_counter() - t0) / repeats)
        del g, xt
    t_single = float(mesh.all_reduce(NODES_AXIS, t_single))

    t0 = time.perf_counter()
    pgraph = partition_graph(graph, n_devices, device=False)
    halo = build_halo(pgraph, device=False)
    plan_build_s = time.perf_counter() - t0
    xs = shard_features(mesh, pad_node_rows(x, pgraph.n_rows_padded))

    propagate_sharded(mesh, pgraph, xs, hops, halo=halo)   # warm
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        propagate_sharded(mesh, pgraph, xs, hops, halo=halo)
    sync(dev)
    slowest = torch.tensor([(time.perf_counter() - t0) / repeats,
                            plan_build_s], dtype=torch.float64, device=dev)
    for axis in (FEAT_AXIS, NODES_AXIS):
        slowest = mesh.all_reduce(axis, slowest, op="max")
    t_sharded, plan_build_s = (float(v) for v in slowest)

    e = graph.nnz * hops
    single_rate = e / t_single
    sharded_rate = e / t_sharded
    return ScalingReport(
        n_devices=n_devices,
        edges=graph.nnz,
        hops=hops,
        single_rate=single_rate,
        sharded_rate=sharded_rate,
        efficiency=sharded_rate / (n_devices * single_rate),
        halo_fraction=halo_fraction(halo, pgraph),
        plan_build_s=plan_build_s,
    )
