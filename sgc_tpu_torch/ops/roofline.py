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
* GAT's attention entries, ``csrc/edge_softmax.cu``
  (:func:`edge_softmax_count`, a function of ``ops/edge_softmax.py`` a
  call): a few FP32 operations an edge; bytes: the row pointers, each
  edge array the function needs (columns, logits, alpha, gradients, the
  mask, the transpose's permutation) read and each it returns written
  once, and the node-sized scores and sums once.
* E and F, ``csrc/probe_copy.cu`` and ``csrc/row_gather.cu``
  (:func:`copy_count`): bytes, the values the output needs read once,
  the output and the index; :func:`copy_bound` sets the launch floor
  (one empty launch through the port's path, measured on the card)
  beside that bound, since at the probes' shapes no launch comes near it.
* G, ``csrc/edge_accumulate.cu``: kernel B's count on the same edges
  (:func:`edges_count`); beside it the chain bound of edge order
  (:func:`chain_bound_ms`): a row's updates stay in edge order, so each
  of a row's features is one dependent chain of f32 adds, and a hub row
  of E edges takes at least E FADD latencies.
* H, ``csrc/blockdense_int8.cu`` (:func:`kernel_h_bound`): kernel A's
  rule with int8 cells (1 byte an entry) and a bf16 x table; beside it
  the bytes its tiles read from L2 (:func:`kernel_h_traffic`: each cell
  byte once a feature tile, each cell's x stripe once a row tile).

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

# a dependent f32 add waits this many cycles for the last (the FADD
# latency; chip_smoke.py measures it, csrc/edge_accumulate.cu::
# edge_chain_cycles), at the SM's boost clock (nvidia-smi clocks.max.sm)
H100_FADD_CYCLES = 4.0
H100_SM_GHZ = 1.98

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


def edges_count(nnz: int, n_rows: int, used_cols: int, F: int,
                dense: bool = False) -> tuple[float, int]:
    """``(ops, bytes)`` of a sum over ``nnz`` edges at width F into
    ``n_rows`` rows, as kernel B counts it: 2 F flops an edge (plus
    ``n_rows F`` adds of a dense term); each edge's (col, val), the row
    pointer, each x row the edges use, the dense term and the output
    once each."""
    ops = 2.0 * nnz * F
    if dense:
        ops += n_rows * F
    nbytes = (nnz * 8 + (n_rows + 1) * 4
              + (used_cols + n_rows * (2 if dense else 1)) * F * 4)
    return ops, nbytes


def kernel_b_count(graph, F: int, dense: bool = False) -> tuple[float, int]:
    """``(ops, bytes)`` of kernel B on ``graph`` at width F, with a dense
    term added in its epilogue when ``dense``."""
    return edges_count(graph.nnz, graph.n_rows, used_columns(graph), F,
                       dense)


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


def edge_softmax_count(graph, fn: str) -> tuple[float, int]:
    """``(ops, bytes)`` of one call of ``fn`` of ``ops/edge_softmax.py``
    on ``graph``, at the least bytes the function needs: ``edge_scores``
    (an add and the leaky rule an edge; the row pointers, the columns
    and the node scores in, the logits and the mask's byte out),
    ``edge_softmax`` (max, difference, exp, sum, quotient; the logits
    in, the attention values out), ``edge_softmax_grad`` (two products,
    a sum and a difference; alpha and g in, the gradient out) and
    ``edge_scores_grad`` (the leaky rule and two sums; the gradient, the
    mask, the transpose's permutation and both row pointers in, the
    row and column sums out). The two launches of ``edge_scores_grad``
    move 8 bytes an edge more, the terms stored in the transpose's order
    and read back; the bound leaves them out."""
    nnz, e_pad = graph.nnz, graph.n_edges_padded
    n, m = graph.n_rows, graph.n_cols
    counts = {
        "edge_scores": (2, 4 * (n + 1) + 4 * nnz + 4 * (n + m)
                        + 5 * e_pad),
        "edge_softmax": (5, 4 * (n + 1) + 4 * nnz + 4 * e_pad),
        "edge_softmax_grad": (4, 4 * (n + 1) + 8 * nnz + 4 * e_pad),
        "edge_scores_grad": (3, 4 * (n + 1) + 4 * (m + 1) + 9 * nnz
                             + 4 * (n + m)),
    }
    per_edge, nbytes = counts[fn]
    return float(per_edge * nnz), nbytes


def edge_softmax_bound(graph, fn: str) -> tuple[float, str, float, int]:
    """``(ms, bound_by, ops, bytes)`` of one call of ``fn``."""
    ops, nbytes = edge_softmax_count(graph, fn)
    return (*bound_ms(ops, nbytes), ops, nbytes)


# ------------------------------------------------ kernels E-H (the probes)

def copy_count(n_read: int, n_out: int, n_index: int = 0,
               ops_per_out: int = 0) -> tuple[float, int]:
    """``(ops, bytes)`` of kernels E and F, which move f32 values: the
    ``n_read`` values the output needs read once, the ``n_out`` written
    once, ``n_index`` int32 indices; ``ops_per_out`` FP32 operations a
    value written (E doubles, F copies)."""
    return float(ops_per_out * n_out), 4 * (n_read + n_out + n_index)


def copy_bound(n_read: int, n_out: int, n_index: int = 0,
               ops_per_out: int = 0,
               launch_floor_ms: float | None = None) -> dict:
    """Kernels E and F's bound (:func:`copy_count`) with the launch floor
    beside it: ``bound_ms`` / ``bound_by`` the larger of the operation
    and byte times, ``launch_floor_ms`` the time of one empty launch
    through the port's path as measured on the card (``None``: not
    measured), ``floor_ms`` the larger of the bound and the launch floor
    and ``floor_by`` which it was (``"launch"`` where no launch could
    come near the bytes)."""
    ops, nbytes = copy_count(n_read, n_out, n_index, ops_per_out)
    ms, by = bound_ms(ops, nbytes)
    out = {"ops": ops, "bytes": nbytes, "bound_ms": ms, "bound_by": by,
           "launch_floor_ms": launch_floor_ms}
    if launch_floor_ms is not None:
        out["floor_ms"] = max(ms, launch_floor_ms)
        out["floor_by"] = "launch" if launch_floor_ms > ms else by
    return out


def chain_bound_ms(n_links: int, cycles_per_link: float = H100_FADD_CYCLES,
                   ghz: float = H100_SM_GHZ) -> float:
    """The least time of one chain of ``n_links`` dependent f32 adds, each
    waiting ``cycles_per_link`` cycles of a ``ghz`` clock for the last:
    the bound of edge order on a row of ``n_links`` edges."""
    return n_links * cycles_per_link / ghz * 1e-6


def kernel_h_traffic(cells, f_pad: int, tile_rows: int = 128,
                     tile_features: int = 256) -> dict:
    """What kernel H's tiles (``tile_rows x tile_features`` of out) read:
    each slot's int8 bytes once a feature tile (and dequantized as often),
    each slot's x stripe (``W x f_pad`` bf16) once a row tile."""
    k, R, W = (int(n) for n in cells.cells.shape)
    feature_tiles = -(-f_pad // tile_features)
    row_tiles = R // tile_rows
    cell_bytes = k * R * W
    x_bytes = k * row_tiles * W * f_pad * 2
    return {"cell_reads": feature_tiles, "feature_tiles": feature_tiles,
            "row_tiles": row_tiles,
            "cell_bytes_read": cell_bytes * feature_tiles,
            "x_bytes_read": x_bytes,
            "l2_bytes_read": cell_bytes * feature_tiles + x_bytes}


def kernel_h_bound(cells, nnz: int, f_pad: int) -> dict:
    """Kernel H's bound on quantized cells (``ops/blockdense_int8.py::
    Int8Cells``) at x width ``f_pad``: kernel A's rule with 1-byte cells,
    the scales, the bf16 x table and the f32 ``[n_rb R, f_pad]`` output;
    2 f_pad flops per nonzero int8 entry at the bf16 tensor-core peak,
    and beside it the dense form's (2 R W f_pad an slot, what the kernel
    executes)."""
    k, R, W = (int(n) for n in cells.cells.shape)
    nbytes = (k * R * W + k * 4 + (cells.n_rb + 1 + 2 * k) * 4
              + cells.n_st * W * f_pad * 2 + cells.n_rb * R * f_pad * 4)
    ops = 2.0 * nnz * f_pad
    dense_ops = 2.0 * R * W * f_pad * k
    b_ms, b_by = bound_ms(ops, nbytes, PEAK_BF16_TC_FLOPS)
    dense_ms, dense_by = bound_ms(dense_ops, nbytes, PEAK_BF16_TC_FLOPS)
    return {"bound_ms": b_ms, "bound_by": b_by, "ops": ops, "bytes": nbytes,
            "cell_nonzeros": nnz, "dense_form_ops": dense_ops,
            "dense_form_bound_ms": dense_ms,
            "dense_form_bound_by": dense_by}


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
