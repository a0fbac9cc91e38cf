"""K-hop feature propagation, the SGC precompute engine (the counterpart
of sgc_tpu/ops/propagate.py).

``Y = S^K X`` is the whole graph-dependent computation of SGC; the
propagated features then feed a head that never touches the graph again
("precompute once, train many"). Every hop is one ``spmm`` call, so the
impls reach the port's kernels:

* ``auto`` / ``segment`` / ``chunked``: kernel B (``csrc/spmm_csr.cu``);
* ``tiled`` (the reference's ``"pallas"``): kernel C over the cached
  tiled layout (ops/spmm_tiled.py);
* ``hybrid``: kernel C on the dense cells + kernel B (ops/spmm_hybrid.py);
* ``blockdense``: kernel A on the bf16 cells (at the reference's default
  ``precision="bf16"``) + kernel B (ops/spmm_blockdense.py).

:func:`sgc_precompute` is the timed entry. For ``tiled``, ``hybrid`` and
``blockdense`` it builds the host layout and places it on the device
before the timer starts, as the reference builds its split "eagerly,
excluded from the timed region"; on the card it also builds and loads
the kernel libraries first, so the timer covers the hops alone.

The reference's ``text_structural_features`` is not ported yet (ROADMAP
queue 1 item 10).
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.spmm import IMPLS, spmm
from sgc_tpu_torch.utils.buildcache import HostBuildCache
from sgc_tpu_torch.utils.profiling import sync


def propagate(x: torch.Tensor, graph: SparseGraph, degree: int,
              impl: str = "auto", collect_hops: bool = False):
    """Apply ``degree`` hops, x <- S @ x. With ``collect_hops=True``
    returns ``(x, hops)``, ``hops`` the feature matrix after each hop."""
    hops = []
    for _ in range(degree):
        x = spmm(graph, x, impl=impl)
        if collect_hops:
            hops.append(x)
    if collect_hops:
        return x, hops
    return x


# row_subgraph is O(E) host work, and K-hop or tuning workflows call
# sgc_precompute again and again with the same (graph, out_rows)
_SUBGRAPH_CACHE = HostBuildCache(8)


def _row_subgraph_cached(graph: SparseGraph, out_rows: np.ndarray):
    out_rows = np.asarray(out_rows)
    # out_rows enters the key as its bytes, not a hash: a collision
    # would return the wrong operator
    return _SUBGRAPH_CACHE.get(
        (graph.rows, graph.cols, graph.vals),
        (graph.nnz, graph.n_rows, graph.n_cols, out_rows.tobytes()),
        lambda: graph.row_subgraph(out_rows))


def _hop(graph: SparseGraph, impl: str, n_features: int, device):
    """``x -> graph @ x`` under ``impl``; a host layout (``tiled``,
    ``hybrid``, ``blockdense``) is built and placed now, cached, so no
    hop builds one. The layouts' parameters are the reference's
    (``spmm_pallas`` defaults; 512 x 512 cells for the splits)."""
    if impl == "tiled":
        from sgc_tpu_torch.ops import spmm_tiled as ti

        tiled, args = ti._tile_cached(graph, ti.DEFAULT_ROW_BLOCK,
                                      ti.DEFAULT_STRIPE, ti.DEFAULT_CHUNK,
                                      device)
        return lambda x: ti.spmm_tiled_flat(tiled, x, args)
    if impl == "hybrid":
        from sgc_tpu_torch.ops import spmm_hybrid as hy

        split, args = hy._split_cached(graph, n_features, 512, 512, 1024,
                                       None, device)
        return lambda x: hy.spmm_hybrid_split(split, x, args)
    if impl == "blockdense":
        from sgc_tpu_torch.ops import spmm_blockdense as bd

        split, args = bd._split_cached(graph, n_features, 512, 512, device)
        return lambda x: bd.spmm_blockdense(split, x, args)
    return lambda x: spmm(graph, x, impl=impl)


def sgc_precompute(features: torch.Tensor, graph: SparseGraph, degree: int,
                   impl: str = "auto", out_rows: np.ndarray | None = None):
    """Timed K-hop propagation. Returns ``(propagated, seconds)``; the
    seconds span the hops on the device (a host clock closed by a sync),
    not the host builds before them.

    ``graph`` must live on the features' device (:meth:`SparseGraph.to`).
    ``out_rows`` (unique node ids) computes only those rows of the last
    hop, through the graph's :meth:`SparseGraph.row_subgraph` (built once
    and cached). That operator keeps each row's edges in order, so under
    ``auto``/``segment``/``chunked`` the rows equal the full result's bit
    for bit; the other impls split it afresh, so they agree to rounding.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown spmm impl {impl!r}; one of {IMPLS}")
    dev = features.device
    if out_rows is not None:
        rows_arr = np.asarray(out_rows)
        if rows_arr.size and (rows_arr.min() < 0
                              or rows_arr.max() >= graph.n_rows):
            raise ValueError(
                f"out_rows must be in [0, {graph.n_rows}); got range "
                f"[{rows_arr.min()}, {rows_arr.max()}]")
    kernels.load_all(dev)
    if out_rows is not None and degree == 0:
        # S^0 X = X: the subset is a row gather
        idx = torch.as_tensor(np.asarray(out_rows), device=dev).long()
        t = perf_counter()
        out = features[idx]
        sync(dev)
        return out, perf_counter() - t
    final = (_row_subgraph_cached(graph, out_rows)
             if out_rows is not None else None)
    nf = int(features.shape[1])
    main_hop = _hop(graph, impl, nf, dev)
    final_hop = _hop(final, impl, nf, dev) if final is not None else None
    n_main = degree - (1 if final is not None else 0)
    t = perf_counter()
    x = features
    for _ in range(n_main):
        x = main_hop(x)
    if final_hop is not None:
        x = final_hop(x)
    sync(dev)
    return x, perf_counter() - t


def propagate_appnp(x: torch.Tensor, graph: SparseGraph, degree: int,
                    alpha: float = 0.1, impl: str = "auto") -> torch.Tensor:
    """APPNP propagation: z_{k+1} = (1-a) S z_k + a x (personalized
    PageRank; Klicpera et al. 2019). Reduces to SGC at alpha=0."""
    z = x
    for _ in range(degree):
        z = (1.0 - alpha) * spmm(graph, z, impl=impl) + alpha * x
    return z


def propagate_ssgc(x: torch.Tensor, graph: SparseGraph, degree: int,
                   alpha: float = 0.05, impl: str = "auto") -> torch.Tensor:
    """SSGC propagation (Zhu & Koniusz 2021): the mean over k = 1..K of
    ``(1-a) S^k x + a x``."""
    acc = torch.zeros_like(x)
    z = x
    for _ in range(degree):
        z = spmm(graph, z, impl=impl)
        acc = acc + (1.0 - alpha) * z + alpha * x
    return acc / degree


PROPAGATORS = {
    "sgc": propagate,
    "appnp": propagate_appnp,
    "ssgc": propagate_ssgc,
}


def fetch_propagator(name: str):
    """Registry over propagation schemes (sgc | appnp | ssgc)."""
    if name not in PROPAGATORS:
        raise ValueError(
            f"unknown propagator {name!r}; one of {list(PROPAGATORS)}")
    return PROPAGATORS[name]
