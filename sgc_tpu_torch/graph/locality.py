"""Locality pipeline (the counterpart of sgc_tpu/graph/locality.py).

Discover a graph's community structure, then exploit it:

    plan = LocalityPlan.build(graph, features, labels, idx_train)
    tr   = plan.propagate_train(degree=2)

* node reordering by LPA (:func:`sgc_tpu_torch.graph.reorder.lpa_order`),
* exact dead-row elimination for the last hop (``row_subgraph``: the
  last hop computes only the ``idx_train`` rows),
* a split per hop operator, placed on the device once per plan: a
  block-dense split (dense bf16 cells + sparse remainder,
  ops/spmm_blockdense.py) or, under ``onehot``, a hybrid split (tiled
  dense cells + sparse remainder, ops/spmm_hybrid.py).

Formulations of the hop:

* ``blockdense_kernel`` is the counterpart of the reference's
  ``blockdense_pallas``: kernel A for the cells and kernel B for the
  remainder, with cells in the super-row order (``super_rows=8``) as in
  the reference.
* ``blockdense`` is the plain PyTorch version (the reference's scan form).
* ``onehot`` is the reference's one-hot/hybrid formulation: cells that
  fill at least ``min_fill`` of their padded chunks go through kernel C
  (the counterpart of ``spmm_pallas_flat``), the rest through kernel B.
  The name is kept for parity; kernel C gathers directly and does no
  one-hot matmul. Its values stay f32 (no bf16 cells); at
  ``precision="bf16"`` kernel C rounds x and each slot's product to bf16,
  as the reference's one-hot kernel does.
* ``auto`` resolves to ``blockdense_kernel`` on a CUDA device and to
  ``blockdense`` on the CPU.

The hop functions take the reference's ``precision`` (default ``"f32"``,
as the reference's bench runs): how x meets the bf16 cells of the
block-dense term (ops/spmm_blockdense.py), or the dense part of the
onehot hop (ops/spmm_hybrid.py).

``blockdense_kernel`` and ``onehot`` on a CUDA device first run the
kernels' capability check, which raises when it fails.

The reference's TPU-VM page-fault probe and its memory arenas are not
carried over; the stage timings ``order_s``, ``subgraph_s`` and
``split_s`` are.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from sgc_tpu_torch.graph.reorder import reorder_graph_arrays
from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.utils.device import resolve_device

FORMULATIONS = ("auto", "blockdense", "blockdense_kernel", "onehot")
SUPER_ROWS = 8


@dataclasses.dataclass(frozen=True)
class LocalityPlan:
    """Reordered graph + per-hop splits, ready for K-hop propagation."""

    graph: SparseGraph            # reordered, normalized operator (host)
    graph_final: SparseGraph      # row-subset operator for the last hop
    features: np.ndarray          # reordered per-node arrays
    labels: np.ndarray
    idx_train: np.ndarray         # positions in the reordered numbering
    order: np.ndarray             # order[new_pos] = old id
    split_main: object            # BlockDenseSplit / HybridSplit (full hops)
    split_final: object           # the same, for the train-row hop
    prep_seconds: dict            # per-stage host prep timing
    device: torch.device
    formulation: str = "blockdense"
    _cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(
        cls,
        graph: SparseGraph,
        features: np.ndarray,
        labels: np.ndarray,
        idx_train: np.ndarray,
        ordering: str = "lpa",
        row_block: int = 512,
        stripe: int = 512,
        min_fill: float | None = None,
        formulation: str = "auto",
        calibrate: bool = False,
        device=None,
    ) -> "LocalityPlan":
        """Host-side prep, once per graph. ``device=None`` means the CUDA
        card (raises without one); ``device="cpu"`` runs the plain forms.

        ``calibrate=True`` replaces the committed block-dense admission
        rates with rates measured on ``device`` through the kernels
        (:func:`sgc_tpu_torch.ops.calibrate.measured_rates`); on the CPU it
        keeps the committed rates. ``min_fill`` is the ``onehot``
        admission threshold (default :func:`min_fill_for`, uncalibrated as
        in the reference); passing it with a block-dense formulation
        raises, as in the reference.
        """
        from sgc_tpu_torch.ops.spmm_blockdense import (
            min_edges_for,
            split_block_dense,
        )

        dev = resolve_device(device)
        if formulation not in FORMULATIONS:
            raise ValueError(f"unknown formulation {formulation!r}; "
                             f"one of {FORMULATIONS}")
        if formulation == "auto":
            formulation = ("blockdense_kernel" if dev.type == "cuda"
                           else "blockdense")
        if min_fill is not None and formulation.startswith("blockdense"):
            raise ValueError(
                "min_fill is the one-hot admission knob; blockdense "
                "admission is the per-cell edge-count crossover "
                "(min_edges_for) — pass formulation='onehot' to use "
                "min_fill")
        if formulation != "blockdense" and dev.type == "cuda":
            from sgc_tpu_torch.ops.capability import require_cuda_kernels

            require_cuda_kernels(dev)

        t = {}
        t0 = time.perf_counter()
        graph_p, features_p, labels_p, idx_p, order = reorder_graph_arrays(
            graph, ordering, features, labels, idx_train)
        t["order_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        graph_final = graph_p.row_subgraph(idx_p)
        t["subgraph_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        nf = int(features_p.shape[1])
        if formulation == "onehot":
            from sgc_tpu_torch.ops.spmm_hybrid import split_dense_cells

            split_main = split_dense_cells(graph_p, nf, row_block, stripe,
                                           min_fill=min_fill)
            split_final = split_dense_cells(graph_final, nf, row_block,
                                            stripe, min_fill=min_fill)
        else:
            min_edges = None
            if calibrate:
                from sgc_tpu_torch.ops.calibrate import measured_rates

                rates = measured_rates(dev)
                min_edges = min_edges_for(
                    row_block, stripe, nf,
                    eff_flops=rates["blockdense_eff_flops"],
                    xla_edges_per_s=rates["xla_edges_per_s"])
            superp = (SUPER_ROWS if formulation == "blockdense_kernel"
                      else None)
            split_main = split_block_dense(graph_p, nf, row_block, stripe,
                                           min_edges=min_edges,
                                           super_rows=superp)
            split_final = split_block_dense(graph_final, nf, row_block,
                                            stripe, min_edges=min_edges,
                                            super_rows=superp)
        t["split_s"] = time.perf_counter() - t0

        return cls(
            graph=graph_p, graph_final=graph_final, features=features_p,
            labels=labels_p, idx_train=idx_p, order=order,
            split_main=split_main, split_final=split_final,
            prep_seconds=t, device=dev, formulation=formulation,
        )

    # ------------------------------------------------------------- compute

    def _device_args(self):
        """Both splits placed on the plan's device, once per plan."""
        if "args" not in self._cache:
            if self.formulation == "onehot":
                from sgc_tpu_torch.ops.spmm_hybrid import (
                    hybrid_device_args as place,
                )
            else:
                from sgc_tpu_torch.ops.spmm_blockdense import (
                    blockdense_device_args as place,
                )
            self._cache["args"] = (place(self.split_main, self.device),
                                   place(self.split_final, self.device))
        return self._cache["args"]

    def _spmm_form(self, split, precision: str):
        """(x, args) -> S @ x for one split, under the plan's formulation
        and the dense term's ``precision`` (ops/spmm_blockdense.py)."""
        from sgc_tpu_torch.ops.spmm_blockdense import (
            check_precision,
            spmm_block_dense,
            spmm_blockdense,
        )
        from sgc_tpu_torch.ops.spmm_hybrid import spmm_hybrid_split

        check_precision(precision)
        if self.formulation == "onehot":
            return lambda x, a: spmm_hybrid_split(split, x, a, precision)
        op = {"blockdense_kernel": spmm_blockdense,
              "blockdense": spmm_block_dense}[self.formulation]
        return lambda x, a: op(split, x, a, precision)

    def hop_fns(self, precision: str = "f32"):
        """``(full_hop, final_hop)``: x -> S @ x on the plan's device,
        with the edge data already placed; cached per ``precision``."""
        key = ("fns", precision)
        if key not in self._cache:
            args_main, args_final = self._device_args()
            full = self._spmm_form(self.split_main, precision)
            final = self._spmm_form(self.split_final, precision)
            self._cache[key] = (lambda x: full(x, args_main),
                                lambda x: final(x, args_final))
        return self._cache[key]

    def khop_traceable(self, degree: int = 2, precision: str = "f32"):
        """``(khop, device_args)``: ``khop(x, device_args)`` computes
        ``(S^degree X)[idx_train]``, the last hop on the train-row
        operator."""
        if degree < 1:
            raise ValueError("degree must be >= 1 (S^0 is a row gather)")
        full_f = self._spmm_form(self.split_main, precision)
        final_f = self._spmm_form(self.split_final, precision)
        device_args = self._device_args()

        def khop(x, args):
            main_args, final_args = args
            for _ in range(degree - 1):
                x = full_f(x, main_args)
            return final_f(x, final_args)

        return khop, device_args

    def _features_on_device(self, features) -> torch.Tensor:
        f = self.features if features is None else features
        return torch.as_tensor(f, dtype=torch.float32, device=self.device)

    def propagate_train(self, degree: int = 2, features=None,
                        precision: str = "f32") -> torch.Tensor:
        """``(S^degree X)[idx_train]``, f32 on the plan's device."""
        khop, args = self.khop_traceable(degree, precision)
        return khop(self._features_on_device(features), args)

    def propagate_all(self, degree: int = 2, features=None,
                      precision: str = "f32",
                      restore: bool = True) -> torch.Tensor:
        """``S^degree X`` for all rows through the full-hop operator; with
        ``restore=True`` rows come back in the original node numbering."""
        if degree < 1:
            raise ValueError("degree must be >= 1")
        full, _ = self.hop_fns(precision)
        x = self._features_on_device(features)
        for _ in range(degree):
            x = full(x)
        if restore:
            inv = np.empty(len(self.order), np.int64)
            inv[self.order] = np.arange(len(self.order))
            x = x[torch.from_numpy(inv).to(x.device)]
        return x

    # --------------------------------------------------------------- utils

    def restore_rows(self, per_node: np.ndarray) -> np.ndarray:
        """Map a per-node array back to the original node numbering."""
        out = np.empty_like(per_node)
        out[self.order] = per_node
        return out

    @property
    def dense_fraction(self) -> float:
        return self.split_main.dense_edges / max(1, self.graph.nnz)
