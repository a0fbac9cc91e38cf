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

:func:`text_structural_features` is the TextSGC precompute: per phase,
the rows of S^K at that phase's doc nodes, min-max scaled on train. Its
first hop is a column slice of S built on the host; the other hops run
in column chunks of at most 2048 (``TEXT_CHUNK``) as dense matmuls
against S densified on the device (``dense``), as ``spmm`` hops
(``sparse``: kernel B on the card), or through the block-dense split of
the doc-word graph (``blockdense``: kernel A on the bf16 cells + kernel
B on the remainder).
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from sgc_tpu_torch.graph.sparse import SparseGraph, host
from sgc_tpu_torch.ops import kernels
from sgc_tpu_torch.ops.scaling import apply_minmax, fit_minmax
from sgc_tpu_torch.ops.spmm import IMPLS, spmm
from sgc_tpu_torch.utils.buildcache import HostBuildCache
from sgc_tpu_torch.utils.device import resolve_device
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


def onehot_selector(n_rows: int, indices: np.ndarray,
                    device=None) -> torch.Tensor:
    """Dense one-hot selector E with ``E[indices[j], j] = 1``
    (float32[n, m]) on ``device`` (``None`` -> the card)."""
    indices = np.asarray(indices)
    sel = np.zeros((n_rows, indices.shape[0]), dtype=np.float32)
    sel[indices, np.arange(indices.shape[0])] = 1.0
    return torch.from_numpy(sel).to(resolve_device(device))


def _sliced_columns(graph: SparseGraph, indices: np.ndarray) -> np.ndarray:
    """Dense ``S[:, indices]`` (host float32[n, m]), built from the edge
    list: the first hop of ``S^K @ E`` is a column slice of S, so no
    one-hot product is needed. Duplicate edges add in edge order
    (``np.add.at``), as in the reference."""
    n = graph.nnz
    rows = host(graph.rows)[:n]
    cols = host(graph.cols)[:n]
    vals = host(graph.vals)[:n]
    indices = np.asarray(indices)
    pos = -np.ones(graph.n_cols, dtype=np.int64)
    pos[indices] = np.arange(indices.shape[0])
    sel = pos[cols] >= 0
    out = np.zeros((graph.n_rows, indices.shape[0]), dtype=np.float32)
    np.add.at(out, (rows[sel], pos[cols[sel]]), vals[sel])
    return out


# Byte budget of the densified S of ``auto``: N^2 f32 (N ~= 23K nodes)
_DENSE_S_MAX_BYTES = 2 << 30
# column chunk of every structural-feature impl (the reference's)
TEXT_CHUNK = 2048
TEXT_IMPLS = ("auto", "dense", "sparse", "blockdense")


def text_impl(graph: SparseGraph, impl: str = "auto",
              degree: int = 2) -> str:
    """The path :func:`text_structural_features` takes for ``impl``:
    ``"slice"`` (degree <= 1: the column slice alone), ``"dense"``,
    ``"blockdense"``, ``"sparse"`` or another ``spmm`` impl passed
    through. ``auto`` is ``dense`` when S's f32 bytes fit
    ``_DENSE_S_MAX_BYTES``, else ``sparse``."""
    if impl not in TEXT_IMPLS + IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of "
                         f"{TEXT_IMPLS + IMPLS}")
    if degree <= 1:
        return "slice"
    if impl == "auto":
        small = graph.n_rows * graph.n_cols * 4 <= _DENSE_S_MAX_BYTES
        return "dense" if small else "sparse"
    return impl


def _dense_s(graph: SparseGraph, device) -> torch.Tensor:
    """S as a dense f32 matrix, densified on ``device`` (the graph's
    edges are coalesced, so each entry is written once)."""
    n = graph.nnz
    s = torch.zeros((graph.n_rows, graph.n_cols), dtype=torch.float32,
                    device=device)
    s[torch.as_tensor(graph.rows[:n], device=device).long(),
      torch.as_tensor(graph.cols[:n], device=device).long()] = \
        torch.as_tensor(graph.vals[:n], device=device)
    return s


def text_structural_features(graph: SparseGraph,
                             index_dict: dict[str, np.ndarray],
                             degree: int = 2, impl: str = "auto"):
    """TextSGC precompute: per-phase rows of S^K, min-max scaled on
    train. Returns ``(feat_dict, precompute_seconds)``.

    Features are S^K column slices transposed (S is symmetric); min and
    range are fit on the train phase, zero-range dims dropped, and the
    same map applied to val and test. ``graph`` lives on the device the
    work runs on (:meth:`SparseGraph.to`). Every phase runs in column
    chunks of at most ``TEXT_CHUNK`` (independent columns, so the
    concatenation is exact); the path is :func:`text_impl`'s:

    * ``dense``: ``torch.matmul`` hops against S densified on the device;
    * ``sparse`` (or an ``spmm`` impl): ``spmm`` hops, kernel B on the
      card under ``sparse``;
    * ``blockdense``: the split of ``graph`` at ``min(width, 2048)``
      features (the committed admission, 512 x 512 cells), its cells
      through kernel A at ``precision="bf16"`` and its remainder through
      kernel B.

    As in :func:`sgc_precompute`, the column slices, the split or the
    dense S, their placement and the kernel libraries are made before
    the timer; the seconds span the hops, the scaling and a sync.
    """
    path = text_impl(graph, impl, degree)
    dev = graph.device
    if dev is None:
        raise ValueError("place the graph on a device first "
                         "(SparseGraph.to)")
    kernels.load_all(dev)
    chunks = {}
    for phase, idx in index_dict.items():
        d = _sliced_columns(graph, idx)
        chunks[phase] = [
            torch.from_numpy(np.ascontiguousarray(d[:, i:i + TEXT_CHUNK]))
            .to(dev) for i in range(0, d.shape[1], TEXT_CHUNK)]
    if path == "dense":
        s_dense = _dense_s(graph, dev)
        hop = lambda x: torch.matmul(s_dense, x)  # noqa: E731
    elif path == "blockdense":
        from sgc_tpu_torch.ops import spmm_blockdense as bd

        width = max(len(np.asarray(i)) for i in index_dict.values())
        split, args = bd._split_cached(graph, min(width, TEXT_CHUNK),
                                       bd.DEFAULT_ROW_BLOCK,
                                       bd.DEFAULT_STRIPE, dev)
        hop = lambda x: bd.spmm_blockdense(split, x, args)  # noqa: E731
    elif path == "slice":
        hop = None
    else:
        sp_impl = "auto" if path == "sparse" else path
        hop = _hop(graph, sp_impl, TEXT_CHUNK, dev)

    t = perf_counter()
    per_phase = {}
    for phase, parts in chunks.items():
        outs = []
        for x in parts:
            for _ in range(degree - 1):
                x = hop(x)
            outs.append(x.T)
        per_phase[phase] = torch.cat(outs, dim=0) if len(outs) > 1 \
            else outs[0].contiguous()
    stats = fit_minmax(per_phase["train"])
    feat_dict = {p: apply_minmax(stats, f) for p, f in per_phase.items()}
    sync(dev)
    return feat_dict, perf_counter() - t


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
