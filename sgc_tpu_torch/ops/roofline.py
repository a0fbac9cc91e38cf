"""Roofline accounting for the port's kernels on one NVIDIA H100 (the
counterpart of sgc_tpu/ops/roofline.py).

The one home of the port's device peaks and of its kernels' byte and
operation counts. A bound is the least time the card could take for a
function's work: the larger of its operations over the peak rate for
their type and its bytes (each input read once, each output written once)
over the memory rate. Where the work depends on the data (a sparse
product), the counts are those of the given inputs.

Peaks: NVIDIA's H100 data sheet, SXM part, dense rates without sparsity,
at the full 700 W power limit: HBM3 3.35 TB/s, bf16 on the tensor cores
989 TFLOP/s, FP32 outside the tensor cores 67 TFLOP/s. A card set below
700 W runs slower under load; report its limit beside any share.
``SGC_TPU_PEAK_GBPS`` / ``SGC_TPU_PEAK_TFLOPS`` override the memory and
tensor-core peaks of :func:`default_peaks` (the reference's variables).

Kernels (``chip_smoke.py`` reports each count beside the kernel's time):

* A, ``csrc/blockdense.cu`` (:func:`kernel_a_bound`): 2 F flops per
  nonzero cell entry and pass at the bf16 tensor-core peak; bytes: the
  bf16 cells, x, out and the cell index once each. Beside it the
  one-pass bound and the dense form's (2 R W F flops per real cell and
  pass, what the kernel executes).
* B, ``csrc/spmm_csr.cu`` (:func:`kernel_b_count`): 2 F flops an edge
  (plus ``n_rows F`` adds of a dense term); bytes: each edge's (col,
  val), the row pointer, each x row the edges use, the dense term and
  the output once each.
* C, kernel B's CUDA kernel on a tiled layout's edges re-sorted by row
  (:func:`kernel_c_count`): 2 F flops per useful edge; bytes: the index
  edges' (col, val), the row pointer, all of x and the output.
* D, ``csrc/sddmm.cu`` (:func:`sddmm_count`): 2 F flops an edge; bytes:
  a and b once each at the operands' width, the edges' rows and cols,
  and the padded output.

:func:`dense_term_cost` and :func:`roofline_report` keep the reference's
signatures and keys, filled from the kernel A and kernel B counts;
:func:`remainder_cost` keeps its keys and takes the split in place of
the reference's edge and row counts. The reference's ``form="scan"``
names ``apply_cells_scan``, which the port leaves out (its CPU twin is
``apply_cells_plain``), so that form raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# one H100 SXM (NVIDIA data sheet)
H100_HBM_GBPS = 3350.0
H100_BF16_TC_TFLOPS = 989.0
H100_FP32_TFLOPS = 67.0

PEAK_HBM_BYTES = H100_HBM_GBPS * 1e9
PEAK_BF16_TC_FLOPS = H100_BF16_TC_TFLOPS * 1e12
PEAK_FP32_FLOPS = H100_FP32_TFLOPS * 1e12


def default_peaks() -> dict:
    return {
        "hbm_gbps": float(os.environ.get("SGC_TPU_PEAK_GBPS",
                                         H100_HBM_GBPS)),
        "bf16_tflops": float(os.environ.get("SGC_TPU_PEAK_TFLOPS",
                                            H100_BF16_TC_TFLOPS)),
        "fp32_tflops": H100_FP32_TFLOPS,
    }


def bound_ms(ops: float, nbytes: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """``(ms, "operations" | "bytes")``: the larger of ``ops`` over
    ``peak_flops`` and ``nbytes`` over the HBM rate, and which it was."""
    t_ops = ops / peak_flops
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------------------------ kernel A

def kernel_a_bytes(split, n_features: int) -> int:
    """Kernel A's bytes on a block-dense split: the bf16 slots, x, out,
    and the index (row-block pointer, each slot's rb and st) once each."""
    R, W, F = split.row_block, split.stripe, int(n_features)
    return (split.n_slots * R * W * 2 + split.n_cols * F * 4
            + split.n_rows * F * 4
            + (split.n_row_blocks + 1 + 2 * split.n_slots) * 4)


def kernel_a_bound(split, dargs, n_cells: int, F: int, passes: int) -> dict:
    """Kernel A's bound on this split's cells (``dargs``: the split placed
    on a device, whose nonzero cell entries are counted), at ``passes``
    bf16 terms of x."""
    R, W = split.row_block, split.stripe
    nnz = int(dargs.cells[: split.n_slots].count_nonzero())
    ops = 2.0 * nnz * F
    dense_ops = 2.0 * R * W * F * n_cells
    nbytes = kernel_a_bytes(split, F)
    b_ms, b_by = bound_ms(ops * passes, nbytes, PEAK_BF16_TC_FLOPS)
    one_ms, _ = bound_ms(ops, nbytes, PEAK_BF16_TC_FLOPS)
    dense_ms, dense_by = bound_ms(dense_ops * passes, nbytes,
                                  PEAK_BF16_TC_FLOPS)
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_one_pass_ms": one_ms,
            "cell_nonzeros": nnz, "ops": ops * passes, "bytes": nbytes,
            "dense_form_ops": dense_ops * passes,
            "dense_form_bound_ms": dense_ms,
            "dense_form_bound_by": dense_by}


# ------------------------------------------------------------------ kernel B

def used_columns(graph) -> int:
    """Distinct columns among a graph's live edges (host or tensors)."""
    cols = graph.cols[: graph.nnz]
    if torch.is_tensor(cols):
        return int(torch.unique(cols).numel())
    return int(np.unique(cols).size)


def kernel_b_count(graph, F: int, dense: bool = False) -> tuple[float, int]:
    """``(ops, bytes)`` of kernel B on ``graph`` at width F, with a dense
    term added in its epilogue when ``dense``."""
    nnz, n_rows = graph.nnz, graph.n_rows
    ops = 2.0 * nnz * F
    if dense:
        ops += n_rows * F
    nbytes = (nnz * 8 + (n_rows + 1) * 4
              + (used_columns(graph) + n_rows * (2 if dense else 1)) * F * 4)
    return ops, nbytes


def b_bound(graph, F: int, dense: bool = False) -> tuple[float, str]:
    return bound_ms(*kernel_b_count(graph, F, dense))


# ------------------------------------------------------------- kernels C, D

def kernel_c_count(tiled, useful_edges: int, index_edges: int,
                   F: int) -> tuple[float, int]:
    """``(ops, bytes)`` of kernel C on a tiled layout whose row-sorted
    index holds ``index_edges`` edges, ``useful_edges`` of them real."""
    ops = 2.0 * useful_edges * F
    nbytes = (index_edges * 8 + (tiled.n_rows + 1) * 4
              + tiled.n_cols * F * 4 + tiled.n_rows * F * 4)
    return ops, nbytes


def sddmm_count(graph, F: int, itemsize: int) -> tuple[float, int]:
    """``(ops, bytes)`` of kernel D at operand width F, a and b read at
    ``itemsize`` bytes a value."""
    ops = 2.0 * graph.nnz * F
    nbytes = ((graph.n_rows + graph.n_cols) * F * itemsize + graph.nnz * 8
              + graph.n_edges_padded * 4)
    return ops, nbytes


def sddmm_bound(graph, F: int, itemsize: int
                ) -> tuple[float, str, float, int]:
    """``(ms, bound_by, ops, bytes)`` of kernel D."""
    ops, nbytes = sddmm_count(graph, F, itemsize)
    return (*bound_ms(ops, nbytes), ops, nbytes)


# ----------------------------------------------------- the reference's API

def _check_form(form: str) -> None:
    if form == "scan":
        raise ValueError(
            "form='scan' names the reference's apply_cells_scan, which the "
            "port leaves out (its CPU twin is apply_cells_plain); the port "
            "counts form='pallas', kernel A")
    if form != "pallas":
        raise ValueError(f"unknown form {form!r}")


def dense_term_cost(split, n_features: int, feature_tile: int | None = None,
                    form: str = "pallas") -> dict:
    """Bytes and flops of the dense-cell term of one hop: ``bytes`` and
    ``cell_bytes`` are kernel A's (:func:`kernel_a_bytes`);
    ``flops_padded`` counts the reference's padded cell list at its
    feature tile, ``flops_useful`` 2 F flops per dense edge, both as the
    reference counts them."""
    from sgc_tpu_torch.ops.spmm_blockdense import default_feature_tile

    _check_form(form)
    R, W = split.row_block, split.stripe
    if feature_tile is None:
        feature_tile = default_feature_tile(n_features)
    ft = min(feature_tile, max(int(n_features), 128))
    f_pad = n_features + ((-n_features) % ft)
    return {
        "bytes": float(kernel_a_bytes(split, n_features)),
        "cell_bytes": float(split.n_slots * R * W * 2),
        "flops_padded": 2.0 * int(split.cells.shape[0]) * R * W * f_pad,
        "flops_useful": 2.0 * split.dense_edges * n_features,
    }


def remainder_cost(split, n_features: int) -> dict:
    """Bytes of a split's remainder term: kernel B on ``split.rest``
    (:func:`kernel_b_count`), adding the dense term in its epilogue when
    the split has cells. The split takes the place of the reference's
    ``(nnz, n_rows)``: kernel B's count needs the remainder's used columns
    and whether a dense term is added. No remainder moves no bytes."""
    rest = split.rest
    if rest is None or rest.nnz == 0:
        return {"bytes": 0.0, "edges": 0}
    _, nbytes = kernel_b_count(rest, n_features, dense=split.n_cells > 0)
    return {"bytes": float(nbytes), "edges": int(rest.nnz)}


def roofline_report(split, n_features: int, dense_s: float, rest_s: float,
                    dispatch_s: float = 0.0, form: str = "pallas",
                    peaks: dict | None = None) -> dict:
    """Measured seconds of a hop's two terms beside their counts: per term
    achieved GB/s and share of the HBM peak, the dense term's share of the
    tensor-core peak (``mxu_frac_*``, the reference's keys), and the
    remainder's edges/s. A term with no work, or no time above
    ``dispatch_s``, reports zeros."""
    peaks = peaks or default_peaks()
    d = dense_term_cost(split, n_features, form=form)
    r = remainder_cost(split, n_features)
    nnz_rest, rest_bytes = r["edges"], r["bytes"]
    dense_net = max(dense_s - dispatch_s, 1e-9)
    rest_net = max(rest_s - dispatch_s, 1e-9)
    no_dense = split.n_cells == 0 or dense_s <= dispatch_s
    no_rest = nnz_rest == 0 or rest_s <= dispatch_s
    return {
        "form": form,
        "dispatch_s": round(dispatch_s, 4),
        "dense": {
            "seconds": round(dense_s, 4),
            "bytes": d["bytes"] if split.n_cells else 0.0,
            "achieved_gbps": 0.0 if no_dense else round(
                d["bytes"] / dense_net / 1e9, 1),
            "hbm_frac": 0.0 if no_dense else round(
                d["bytes"] / dense_net / 1e9 / peaks["hbm_gbps"], 3),
            "mxu_frac_padded": 0.0 if no_dense else round(
                d["flops_padded"] / dense_net / 1e12
                / peaks["bf16_tflops"], 3),
            "mxu_frac_useful": 0.0 if no_dense else round(
                d["flops_useful"] / dense_net / 1e12
                / peaks["bf16_tflops"], 4),
        },
        "remainder": {
            "seconds": round(rest_s, 4),
            "edges": nnz_rest,
            "bytes": rest_bytes,
            "achieved_gbps": 0.0 if no_rest else round(
                rest_bytes / rest_net / 1e9, 1),
            "hbm_frac": 0.0 if no_rest else round(
                rest_bytes / rest_net / 1e9 / peaks["hbm_gbps"], 3),
            "edges_per_s": 0 if no_rest else int(nnz_rest / rest_net),
        },
        "peaks": peaks,
    }
