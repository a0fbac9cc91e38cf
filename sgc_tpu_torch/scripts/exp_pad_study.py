"""Chunk padding of the cell grid, per ordering and tile (the counterpart
of scripts/exp_pad_study.py; host only).

The reference's flat one-hot kernel pays ``2 (W + R) F_pad`` flops per
padded edge, so its operating point is the chunk-padding factor of the
(row block, stripe) cell grid: each nonempty cell's edges are padded to
whole chunks of 1,024. For the synthetic Reddit graph at ``--scale``, in
identity, degree and RCM order, at R in {256, 512, 1024, 2048} and W in
{512, 1024, 2048}, each line gives the reference's fields: ``pad``
(padded slots over edges), ``nonempty`` cells, ``proxy_Mflop_per_edge``
(the one-hot flops per edge) and ``x_traffic_gb`` (a stripe of x read
per nonempty cell), bit for bit the reference's.

Two fields differ from the reference's, by name and by what they state:

* ``tpu_v5e_proj_hop_s`` is the reference's ``proj_hop_s``: the one-hot
  flops over ``TPU_V5E_ONEHOT_FLOPS`` = 142e12, the sustained rate the
  reference measured for its kernel on a TPU v5e (~72% of that chip's
  197e12 MXU peak). It is a TPU projection, not a time of this port.
* ``c_bound_ms`` is kernel C's bound on the card for the same graph
  (``ops/roofline.py::kernel_c_count`` over the H100 data-sheet peaks):
  kernel C gathers rows directly, with no one-hot matmul, and drops the
  chunk padding when it re-sorts the layout by row, so its bound is the
  same at every tile; the tiling moves only the TPU projection.

"BEST:" is the reference's pick, the least TPU projection. A first
line gives the device's own figures (``--device``; the script runs on
the host only). The RCM order is a plain call: where the reference
printed a failure and went on, a failure here raises.

    python -m sgc_tpu_torch.scripts.exp_pad_study [--scale 1.0]
        [--features 602] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sp
import torch

from sgc_tpu_torch.data.synthetic import synthetic_reddit
from sgc_tpu_torch.graph.reorder import degree_order, rcm_order
from sgc_tpu_torch.graph.sparse import host
from sgc_tpu_torch.ops import roofline
from sgc_tpu_torch.scripts import backend, device_parser
from sgc_tpu_torch.utils.device import resolve_device

CHUNK = 1024  # the reference's chunk (a TPU Mosaic floor: 8 x 128 lanes)
ROW_BLOCKS = (256, 512, 1024, 2048)
STRIPES = (512, 1024, 2048)
# the reference's measured sustained rate of its one-hot kernel on a TPU
# v5e (0.72 x 197e12 flop/s); a TPU figure, used only for the projection
TPU_V5E_ONEHOT_FLOPS = 142e12


def device_figures(device: torch.device) -> dict:
    """The device's own figures, printed beside the TPU projection: its
    name and memory (``torch.cuda.get_device_properties``) and the H100
    peaks of ``ops/roofline.py`` (data-sheet rates)."""
    out = {"device": backend(device),
           "hbm_gbps": roofline.H100_HBM_GBPS,
           "bf16_tc_tflops": roofline.H100_BF16_TC_TFLOPS,
           "fp32_tflops": roofline.H100_FP32_TFLOPS,
           "peaks_of": "NVIDIA H100 SXM data sheet (ops/roofline.py)"}
    if device.type == "cuda":
        out["memory_bytes"] = torch.cuda.get_device_properties(
            device).total_memory
    return out


def pad_stats(rows: np.ndarray, cols: np.ndarray, n: int, rb: int,
              w: int) -> dict:
    """The reference's: padded slots over edges, nonempty cells, cells."""
    n_rb = -(-n // rb)
    n_st = -(-n // w)
    cell = (rows // rb) * n_st + (cols // w)
    counts = np.bincount(cell, minlength=n_rb * n_st)
    nonzero = counts[counts > 0]
    chunks = -(-nonzero // CHUNK)
    e_pad = int(chunks.sum()) * CHUNK
    return {
        "pad": e_pad / len(rows),
        "nonempty_cells": int(len(nonzero)),
        "cells": int(n_rb * n_st),
    }


def orderings(adj: sp.csr_matrix) -> dict:
    """``{name: order or None}``: identity, degree and RCM, each timed on
    stdout as the reference does."""
    out = {"identity": None}
    t0 = time.time()
    out["degree"] = degree_order(adj)
    print(f"degree order: {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    out["rcm"] = rcm_order(adj)
    print(f"rcm order: {time.time() - t0:.1f}s", flush=True)
    return out


def study(rows: np.ndarray, cols: np.ndarray, n: int, orders: dict,
          n_features: int = 602) -> list:
    """One line per (ordering, R, W), printed as JSON; returns them."""
    e = len(rows)
    f_total = -(-n_features // 128) * 128   # the reference's lane padding
    ops, nbytes = roofline.kernel_c_count(
        SimpleNamespace(n_rows=n, n_cols=n), e, e, n_features)
    c_ms, c_by = roofline.bound_ms(ops, nbytes)
    results = []
    for oname, order in orders.items():
        if order is None:
            r, c = rows, cols
        else:
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            r, c = inv[rows], inv[cols]
        for rb in ROW_BLOCKS:
            for w in STRIPES:
                s = pad_stats(r, c, n, rb, w)
                flops_per_edge = 2 * (w + rb) * f_total * s["pad"]
                hop_s = flops_per_edge * e / TPU_V5E_ONEHOT_FLOPS
                x_gb = s["nonempty_cells"] * w * f_total * 4 / 1e9
                row = {"order": oname, "rb": rb, "w": w,
                       "pad": round(s["pad"], 3),
                       "nonempty": s["nonempty_cells"],
                       "proxy_Mflop_per_edge": round(flops_per_edge / 1e6,
                                                     3),
                       "tpu_v5e_proj_hop_s": round(hop_s, 4),
                       "x_traffic_gb": round(x_gb, 2),
                       "c_bound_ms": c_ms, "c_bound_by": c_by}
                results.append(row)
                print(json.dumps(row), flush=True)
    return results


def run(graph, n_features: int = 602) -> list:
    """Every line on a host graph; then "BEST:"."""
    n = graph.n_rows
    rows = host(graph.rows)[: graph.nnz].astype(np.int64)
    cols = host(graph.cols)[: graph.nnz].astype(np.int64)
    e = len(rows)
    print(f"nodes={n} edges={e}", flush=True)
    adj = sp.coo_matrix((np.ones(e, np.float32), (rows, cols)),
                        shape=(n, n)).tocsr()
    results = study(rows, cols, n, orderings(adj), n_features)
    best = min(results, key=lambda r: r["tpu_v5e_proj_hop_s"])
    print("BEST:", json.dumps(best), flush=True)
    return results


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--features", type=int, default=602)
    a = p.parse_args(argv)
    print("device:", json.dumps(device_figures(resolve_device(a.device))),
          flush=True)
    graph, _, _, _ = synthetic_reddit(a.scale)
    run(graph, a.features)
    return 0


if __name__ == "__main__":
    sys.exit(main())
