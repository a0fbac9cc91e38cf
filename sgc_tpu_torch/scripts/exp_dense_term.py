"""Dense-term experiments on the card (the counterpart of
scripts/exp_dense_term.py): kernel A at "bf16" beside kernel H, the same
dense-cell term on int8 cells with a scale per cell (half of A's cell
bytes).

``main`` builds the reference's plan (the clustered Reddit-shaped graph
at ``--scale``, shuffled; ``LocalityPlan.build(calibrate=True)`` in the
super-row cell order) and runs :func:`run` on its main split. On the
H100 that calibrated split admits no cell (ROADMAP queue 3 item 1), so
``main`` raises there; :func:`run` takes any split, and ``chip_smoke.py``
drives it on the main path's split at the committed admission.

What :func:`run` prints, each time the best of ``reps`` host-clock runs
closed by a sync, with the dispatch floor beside it:

1. kernel A at "bf16" (``ops/spmm_blockdense.py::apply_cells``) once. The
   reference sweeps its Pallas kernel's feature tile (256, 512, 768);
   kernel A has no feature tile (it tiles features by 128 itself), so
   the sweep is one timing, and A's row sums are the reference row sums.
2. the cells quantized per cell (``ops/blockdense_int8.py::
   quantize_cells``, the reference's numpy recipe bit for bit), then
   kernel H with x padded to a multiple of ft in {256, 768} (the
   reference's two int8 legs), each with its row sums' max error
   against kernel A's relative to their max.

The reference's int8 kernel is right only for cells in (rb, st) order
and runs on the super-row split (ROADMAP queue 3 item 23); kernel H
computes the intended function in either order.

    python -m sgc_tpu_torch.scripts.exp_dense_term [--scale 1.0]
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from sgc_tpu_torch.data.synthetic import synthetic_reddit_clustered
from sgc_tpu_torch.graph.locality import LocalityPlan
from sgc_tpu_torch.ops import blockdense_int8 as h
from sgc_tpu_torch.ops import spmm_blockdense as bd
from sgc_tpu_torch.scripts import backend, best_seconds, device_parser, log
from sgc_tpu_torch.utils.device import resolve_device

INT8_FEATURE_TILES = (256, 768)


def run(split, x: torch.Tensor, dargs=None, reps: int = 3) -> dict:
    """Kernel A at "bf16" and kernel H at each int8 feature tile on the
    dense cells of ``split`` (a block-dense split; ``dargs`` its placed
    arguments on x's device, placed here when None)."""
    dev = x.device
    log(f"backend: {backend(dev)}")
    if split.n_cells == 0:
        raise ValueError("the split has no dense cell")
    if dargs is None:
        dargs = bd.blockdense_device_args(split, dev)
    log(f"cells {split.n_cells} ({split.cell_bytes / 1e9:.2f} GB bf16)")
    floor, _ = best_seconds(lambda: torch.ones((8, 128), device=dev) * 2.0, reps)
    log(f"dispatch floor {floor * 1e3:.1f} ms")

    t_a, out_a = best_seconds(lambda: bd.apply_cells(split, dargs, x, "bf16"), reps)
    ref_row_sum = out_a.sum(dim=1)
    log(f"kernel A bf16 (no feature tile: the reference's sweep over "
        f"256 / 512 / 768 is this one timing): {t_a * 1e3:.1f} ms (net "
        f"{(t_a - floor) * 1e3:.1f})")

    q, scales = h.quantize_cells(dargs.cells)
    cells = h.int8_cells(q, scales, split.rb_ids, split.st_ids,
                         split.n_row_blocks, split.n_stripes)
    result = {"dispatch_floor_ms": floor * 1e3, "kernel_a_bf16_ms": t_a * 1e3,
              "cells": split.n_cells, "slots": int(q.shape[0]),
              "int8": {}, "quantized": cells, "kernel_a_out": out_a}
    scale = max(float(ref_row_sum.abs().max()), 1e-9)
    for ft in INT8_FEATURE_TILES:
        xp = h.pad_x_bf16(x, split.n_stripes * split.stripe, ft)
        t8, out8 = best_seconds(lambda: h.apply_cells_int8(cells, xp), reps)
        row8 = out8[: split.n_rows, : x.shape[1]].sum(dim=1)
        err8 = float((row8 - ref_row_sum).abs().max()) / scale
        log(f"int8 cells ft{ft}: {t8 * 1e3:.1f} ms (net "
            f"{(t8 - floor) * 1e3:.1f}) rowsum_rel_err_vs_bf16 {err8:.1e}")
        result["int8"][ft] = {"ms": t8 * 1e3, "rowsum_rel_err_vs_bf16": err8,
                              "f_pad": int(xp.shape[1]), "xp": xp,
                              "out": out8}
    return result


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--scale", type=float, default=1.0)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    graph, features, labels, idx_train = synthetic_reddit_clustered(
        a.scale, shuffle=True)
    plan = LocalityPlan.build(graph, features, labels, idx_train,
                              formulation="blockdense_kernel",
                              calibrate=True, device=dev)
    split = plan.split_main
    if split.n_cells == 0:
        raise RuntimeError(
            "the calibrated split admits no dense cell on this device "
            "(ROADMAP queue 3 item 1): the measured cell rate needs "
            f"{split.min_edges:.0f} edges a cell; run() takes any split")
    log(f"dense_frac {plan.dense_fraction:.3f}")
    run(split, torch.as_tensor(plan.features, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
