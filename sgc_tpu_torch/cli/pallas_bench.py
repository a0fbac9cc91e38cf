"""Microbench of the Hopper SpMM kernels on a synthetic Reddit-shape graph
(the counterpart of sgc_tpu/cli/pallas_bench.py), on the card by default:

    python -m sgc_tpu_torch.cli.pallas_bench --scale 0.1 --precision bf16
    python -m sgc_tpu_torch.cli.pallas_bench --clustered --blockdense --json

On one graph (``synthetic_reddit``, or the clustered recipe with
``--clustered`` or ``--blockdense``) it times kernel B
(``spmm_segment``: the reference's XLA segment path, so its keys
``xla_segment_s`` / ``xla_edges_per_s``), then kernel C on the graph's
tiled layout (``--row_block``, ``--stripe``, ``--chunk``) through the
flat entry (``--flat``) or the stripe entry, at ``--precision``. With
``--blockdense`` it also times the block-dense split (512 x 512 cells,
``"bf16"`` as the reference's defaults) through its plain version
(``spmm_block_dense``: ``blockdense_*``) and through kernels A and B
(``spmm_blockdense``: ``blockdense_pallas_*``). Each time is the least
of ``--repeats`` runs after one warm call, each run closed by a sync of
its output's device (``utils/profiling.py::timed_runs``);
each error is max |out - kernel B's| over max |kernel B's|, and
``blockdense_pallas_vs_plain_rel_err`` holds kernels A + B against the
plain version on the same split and precision.

The line holds the reference's keys plus ``device`` and, with
``--blockdense``, ``blockdense_pallas_vs_plain_rel_err``. ``cost_model``
gives the tiled layout as the reference's ``pallas_cost_model`` does
(``edges_padded``, ``padding_factor``, ``n_row_blocks``, ``n_stripes``,
``n_feature_tiles`` at ``--feature_tile``, which sets nothing else:
kernel C reads whole rows) and the port's counts and bounds from
``ops/roofline.py`` for kernel C (``flops``, ``bytes_accessed``), kernel
B (``segment``) and, with ``--blockdense``, kernel A (``blockdense``).
The reference records a kernel's failure under ``*_error`` keys; here a
kernel that fails to build or launch raises. ``--interpret`` raises:
there is no interpreter to force on the card (``--device cpu`` runs the
plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sgc_tpu_torch.ops import roofline
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import timed_runs


def cost_model(tiled, feature_dim: int, feature_tile: int, flat: bool,
               useful_edges: int, index_edges: int) -> dict:
    """The tiled layout's fields (as the reference's
    ``pallas_cost_model``) and kernel C's counts and bound on it."""
    ft = min(feature_tile, max(feature_dim, 128))
    ft = -(-ft // 128) * 128
    f_pad = feature_dim + ((-feature_dim) % ft)
    e_padded = int(tiled.rows.shape[0])
    ops, nbytes = roofline.kernel_c_count(tiled, useful_edges, index_edges,
                                          feature_dim)
    b_ms, b_by = roofline.bound_ms(ops, nbytes)
    return {
        "kernel": "flat" if flat else "stripes",
        "edges_padded": e_padded,
        "padding_factor": e_padded / max(1, int(
            np.count_nonzero(tiled.vals))),
        "flops": int(ops),
        "bytes_accessed": int(nbytes),
        "n_row_blocks": tiled.n_row_blocks,
        "n_stripes": tiled.n_stripes,
        "n_feature_tiles": f_pad // ft,
        "index_edges": index_edges,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=float, default=0.1,
                   help="fraction of Reddit dimensions for the synthetic "
                        "graph")
    p.add_argument("--row_block", type=int, default=2048)
    p.add_argument("--stripe", type=int, default=2048)
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--feature_tile", type=int, default=256,
                   help="accepted for the reference's flag set; sets only "
                        "cost_model's n_feature_tiles (kernel C reads whole "
                        "rows)")
    p.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    p.add_argument("--interpret", action="store_true",
                   help="the reference's interpreter switch; raises here")
    p.add_argument("--flat", action="store_true",
                   help="kernel C through the flat entry instead of the "
                        "stripe entry")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--json", action="store_true")
    p.add_argument("--blockdense", action="store_true",
                   help="also time the block-dense split (plain, and "
                        "kernels A + B) on the clustered graph")
    p.add_argument("--clustered", action="store_true",
                   help="the community-clustered synthetic for all paths "
                        "(default: uniform)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-9))


def run(a: argparse.Namespace) -> dict:
    """The bench's result dict (see the module docstring)."""
    from sgc_tpu_torch.data.synthetic import (
        synthetic_reddit,
        synthetic_reddit_clustered,
    )
    from sgc_tpu_torch.ops import spmm_tiled as ti
    from sgc_tpu_torch.ops.spmm import spmm_segment

    if a.interpret:
        raise ValueError(
            "--interpret forces the reference's Pallas interpreter; the "
            "port's kernels have none (--device cpu runs their plain "
            "versions)")
    dev = resolve_device(a.device)
    clustered = a.clustered or a.blockdense
    make = synthetic_reddit_clustered if clustered else synthetic_reddit
    graph, features, _, _ = make(a.scale)
    n, f = features.shape
    g = graph.to(dev)
    x = torch.as_tensor(features, device=dev)
    out = {"backend": dev.type,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "nodes": n, "edges": graph.nnz, "features": f,
           "topology": "clustered" if clustered else "uniform"}

    ts, ref = timed_runs(lambda: spmm_segment(g, x), a.repeats)
    t_seg = out["xla_segment_s"] = min(ts)
    out["xla_edges_per_s"] = int(graph.nnz / t_seg)

    tiled = ti.tile_graph(graph, a.row_block, a.stripe, a.chunk)
    targs = ti.tiled_device_args(tiled, dev)
    out["cost_model"] = cost_model(tiled, f, a.feature_tile, a.flat,
                                   graph.nnz, int(targs.cols.shape[0]))
    seg_ops, seg_bytes = roofline.kernel_b_count(g, f)
    out["cost_model"]["segment"] = {
        "flops": int(seg_ops), "bytes_accessed": int(seg_bytes),
        **dict(zip(("bound_ms", "bound_by"),
                   roofline.bound_ms(seg_ops, seg_bytes)))}
    out["pallas_mode"] = "compiled" if dev.type == "cuda" else "plain"
    out["pallas_kernel"] = "flat" if a.flat else "stripes"
    entry = ti.spmm_tiled_flat if a.flat else ti.spmm_tiled_stripes
    ts, r = timed_runs(lambda: entry(tiled, x, targs, a.precision),
                       a.repeats)
    t_pal = out["pallas_s"] = min(ts)
    out["pallas_edges_per_s"] = int(graph.nnz / t_pal)
    out["pallas_vs_xla"] = t_seg / t_pal
    out["rel_err_vs_xla"] = _rel_err(r, ref)
    del targs, r

    if a.blockdense:
        from sgc_tpu_torch.ops.spmm_blockdense import (
            blockdense_device_args,
            n_passes,
            split_block_dense,
            spmm_block_dense,
            spmm_blockdense,
        )

        split = split_block_dense(graph, f)
        out["blockdense_cells"] = split.n_cells
        out["blockdense_dense_edges"] = split.dense_edges
        out["blockdense_cell_gb"] = split.cell_bytes / 1e9
        bargs = blockdense_device_args(split, dev)
        ts, plain = timed_runs(lambda: spmm_block_dense(split, x, bargs),
                               a.repeats)
        t_bd = out["blockdense_s"] = min(ts)
        out["blockdense_edges_per_s"] = int(graph.nnz / t_bd)
        out["blockdense_vs_xla"] = t_seg / t_bd
        out["blockdense_rel_err_vs_xla"] = _rel_err(plain, ref)
        ts, r = timed_runs(lambda: spmm_blockdense(split, x, bargs),
                           a.repeats)
        t_bdk = out["blockdense_pallas_s"] = min(ts)
        out["blockdense_pallas_vs_xla"] = t_seg / t_bdk
        out["blockdense_pallas_rel_err"] = _rel_err(r, ref)
        out["blockdense_pallas_vs_plain_rel_err"] = _rel_err(r, plain)
        bound = roofline.kernel_a_bound(split, bargs, split.n_cells, f,
                                        n_passes("bf16"))
        out["cost_model"]["blockdense"] = {
            k: bound[k] for k in ("ops", "bytes", "bound_ms", "bound_by",
                                  "cell_nonzeros")}
    return out


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    out = run(a)
    if a.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
