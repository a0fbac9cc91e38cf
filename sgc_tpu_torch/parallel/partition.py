"""Row-block edge partitioning (the counterpart of
sgc_tpu/parallel/partition.py).

Each of P parts owns a contiguous block of destination rows of S and the
matching rows of the node features. Edges go to the part that owns their
destination row, with block-local row ids, padded to one per-part edge
count, so the host arrays stack into ``[P, E_max]``; the arrays equal the
reference's bit for bit. Padding edges are (row ``rows_per_part - 1``,
col ``n_cols - 1``, val 0), as the reference's native fill writes them.

Partitioning happens once on the host. Each rank then places only its
own part on its device (``parallel/spmm.py``), so the stacked arrays
stay host numpy in practice; ``device`` places all of them on one device
for callers that want that.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sgc_tpu_torch import native
from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.utils.device import resolve_device

# Per-part edge padding granularity (the reference's, a multiple of its
# TPU's 8 x 128 vector tile; kept so the arrays compare bit for bit).
PART_EDGE_PAD = 1024


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if n > 0 else m


def place(a, device):
    """``a`` as given for ``device=False``, else a tensor on ``device``
    (``True`` -> the CUDA card)."""
    if device is False:
        return a
    return torch.as_tensor(a, device=resolve_device(
        None if device is True else device))


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """P row blocks of a sparse matrix, stacked along a leading axis.

    Attributes:
      rows_local: int32[P, E_max], destination row local to the block.
      cols:       int32[P, E_max], global source column.
      vals:       float32[P, E_max], 0 on padding edges.
      n_parts, rows_per_part: partition geometry; padded rows =
                  n_parts * rows_per_part.
      n_rows, n_cols: the unpadded matrix shape.
      nnz:        the true edge count across all parts.
    """

    rows_local: np.ndarray | torch.Tensor
    cols: np.ndarray | torch.Tensor
    vals: np.ndarray | torch.Tensor
    n_parts: int
    rows_per_part: int
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def n_rows_padded(self) -> int:
        return self.n_parts * self.rows_per_part

    @property
    def edges_per_part(self) -> int:
        return int(self.rows_local.shape[1])


def partition_graph(
    graph: SparseGraph,
    n_parts: int,
    row_align: int = 8,
    edge_pad: int = PART_EDGE_PAD,
    device=True,
) -> PartitionedGraph:
    """Split ``graph`` into ``n_parts`` contiguous row blocks (host side).

    Rows are padded so every part owns the same number of rows (aligned to
    ``row_align``); per-part edge lists are padded to the largest part,
    rounded up to ``edge_pad``. ``device=False`` keeps the arrays host
    numpy (what the plan builders and the ranks read); ``True`` places
    them on the card, any other value on that device.
    """
    rows = host(graph.rows)[: graph.nnz]
    cols = host(graph.cols)[: graph.nnz]
    vals = host(graph.vals)[: graph.nnz]

    rows_per_part = _round_up(-(-graph.n_rows // n_parts), row_align)

    counts = native.edge_counts(rows, n_parts, rows_per_part)
    e_max = _round_up(int(counts.max()) if counts.size else 0, edge_pad)
    p_rows, p_cols, p_vals = native.partition_edges(
        rows, cols, vals, n_parts, rows_per_part, e_max, graph.n_cols)

    return PartitionedGraph(
        rows_local=place(p_rows, device),
        cols=place(p_cols, device),
        vals=place(p_vals, device),
        n_parts=n_parts,
        rows_per_part=rows_per_part,
        n_rows=graph.n_rows,
        n_cols=graph.n_cols,
        nnz=graph.nnz,
    )


def pad_node_rows(x, n_rows_padded: int):
    """Zero-pad the node (row) dimension of features up to the partition
    size; a numpy array stays numpy, a tensor stays on its device."""
    pad = n_rows_padded - x.shape[0]
    if pad < 0:
        raise ValueError(f"features have {x.shape[0]} rows > padded "
                         f"{n_rows_padded}")
    if torch.is_tensor(x):
        return x if pad == 0 else torch.cat(
            [x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return x if pad == 0 else np.concatenate(
        [x, np.zeros((pad,) + x.shape[1:], dtype=x.dtype)])


def pad_feature_dim(x, multiple: int):
    """Zero-pad the trailing feature dimension to a multiple (for the
    ``"feat"`` sharding); numpy or tensor, as given."""
    f = x.shape[-1]
    target = _round_up(f, multiple)
    if target == f:
        return x
    if torch.is_tensor(x):
        return torch.nn.functional.pad(x, (0, target - f))
    pad_widths = [(0, 0)] * (x.ndim - 1) + [(0, target - f)]
    return np.pad(x, pad_widths)
