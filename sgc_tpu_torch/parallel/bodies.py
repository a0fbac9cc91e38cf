"""Rank bodies: the functions spawned ranks run for the CPU parity tests
(``tests/test_torch_port_sharded.py``) and for the chip smoke's
``sharded_path`` phase. They live in the port because a spawned rank
unpickles its target by module name and must import nothing else.

Plans reach the ranks as files (``distributed.save_host``), laid out
under one directory::

    x.npy, labels.npy, idx_train.npy   features and targets (plan order)
    graph/                             the whole graph (SparseGraph)
    p<P>/pgraph, p<P>/halo, p<P>/bd    PartitionedGraph, the overlapped
                                       HaloDescriptor, ShardedBlockDense

* :func:`sharded_checks` (CPU, 4 ranks): every ``spmm_sharded`` branch
  on meshes (4, 1) and (2, 2), ``col_chunk`` bits and rejections, the
  overlapped hops' launch order, ``validate_exchange``,
  ``assert_deterministic``, ``put_global`` / ``fetch_global`` round
  trips and the train step; rank 0 returns what it gathered.
* :func:`smoke_world` (the card, 4 ranks, gloo) and
  :func:`smoke_world_of_one` (the card, 1 rank, NCCL beside gloo): the
  smoke's forms with every kernel launch held against its plain version,
  times, launches, the train step and the scaling harness. Their
  ``cfg["device"]`` is None on the card (each rank's own) and ``"cpu"``
  only for a rehearsal of the phase on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from sgc_tpu_torch.ops import spmm as spmm_ops
from sgc_tpu_torch.ops import spmm_blockdense as bd_ops
from sgc_tpu_torch.parallel import blockdense as bd_mod
from sgc_tpu_torch.parallel import halo as halo_mod
from sgc_tpu_torch.parallel.debug import (
    assert_deterministic,
    validate_exchange,
)
from sgc_tpu_torch.parallel.distributed import (
    NODE_FEAT,
    fetch_global,
    load_host,
    put_global,
)
from sgc_tpu_torch.parallel.mesh import (
    FEAT_AXIS,
    NODES_AXIS,
    Mesh,
    Pending,
    make_mesh,
)
from sgc_tpu_torch.parallel.partition import pad_node_rows, partition_graph
from sgc_tpu_torch.parallel.spmm import (
    local_view,
    propagate_sharded,
    shard_features,
    spmm_sharded,
)
from sgc_tpu_torch.parallel.train import (
    make_sharded_train_step,
    place_node_targets,
    sharded_state_from_jax,
)
from sgc_tpu_torch.utils.profiling import read_counts, sync, zero_counts

# every kernel's launch counter in utils/profiling.py's registry, by its
# name in the chip smoke's kernels line (the sharded path launches A and
# B only; the rest read 0)
COUNTERS = {"blockdense_cells": "launch.blockdense_cells",
            "csr_spmm": "launch.csr_spmm",
            "tiled_spmm": "launch.tiled_spmm",
            "sddmm": "launch.sddmm",
            "csr_spmm_transposed": "within.csr_spmm_transposed",
            # the sharded hops' backwards (parallel/autograd.py), also
            # counted in blockdense_cells and csr_spmm
            "blockdense_cells_backward": "within.blockdense_cells_backward",
            "csr_spmm_backward": "within.csr_spmm_backward"}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|); raises on non-finite
    values."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output has non-finite values")
    abs_err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return abs_err, abs_err / max(scale, 1e-30)


@contextlib.contextmanager
def hold_launches(record: list):
    """Inside, every kernel-A and kernel-B call of the sharded hops is
    held against its plain version on the same inputs; ``record`` gets
    ``(counter name, max_abs_err, rel_err)`` per call. The plain versions
    count no launch."""
    run_b, run_a = halo_mod.spmm_segment, bd_mod.apply_cells

    def held_b(graph, x, dense=None):
        out = run_b(graph, x, dense)
        record.append(("csr_spmm",) + rel_err(
            out, spmm_ops.spmm_segment_plain(graph, x, dense)))
        return out

    def held_a(split, args, x, precision="bf16"):
        out = run_a(split, args, x, precision)
        record.append(("blockdense_cells",) + rel_err(
            out, bd_ops.apply_cells_plain(split, args, x, precision)))
        return out

    halo_mod.spmm_segment, bd_mod.apply_cells = held_b, held_a
    try:
        yield record
    finally:
        halo_mod.spmm_segment, bd_mod.apply_cells = run_b, run_a


@contextlib.contextmanager
def trace_order(events: list):
    """Inside, the exchange's start and wait and every kernel call append
    to ``events``: ``"exchange"``, ``"wait"``, ``("B" | "A", rows of the
    operand)``."""
    run_b, run_a = halo_mod.spmm_segment, bd_mod.apply_cells
    a2a, wait = Mesh.all_to_all, Pending.wait

    def traced_a2a(self, axis, send, async_op=False):
        events.append("exchange")
        return a2a(self, axis, send, async_op)

    def traced_wait(self):
        events.append("wait")
        return wait(self)

    def traced_b(graph, x, dense=None):
        events.append(("B", int(x.shape[0])))
        return run_b(graph, x, dense)

    def traced_a(split, args, x, precision="bf16"):
        events.append(("A", int(x.shape[0])))
        return run_a(split, args, x, precision)

    Mesh.all_to_all, Pending.wait = traced_a2a, traced_wait
    halo_mod.spmm_segment, bd_mod.apply_cells = traced_b, traced_a
    try:
        yield events
    finally:
        Mesh.all_to_all, Pending.wait = a2a, wait
        halo_mod.spmm_segment, bd_mod.apply_cells = run_b, run_a


def write_inputs(plan_dir, graph, x, labels, idx_train) -> None:
    """Write the inputs every body reads (module docstring): features,
    targets and the whole graph."""
    from sgc_tpu_torch.parallel.distributed import save_host

    plan_dir = Path(plan_dir)
    plan_dir.mkdir(parents=True, exist_ok=True)
    np.save(plan_dir / "x.npy", np.asarray(x, np.float32))
    np.save(plan_dir / "labels.npy", np.asarray(labels))
    np.save(plan_dir / "idx_train.npy", np.asarray(idx_train))
    save_host(plan_dir / "graph", graph)


def write_plans(plan_dir, graph, parts: dict, **bd_kw) -> dict:
    """Build and write the host plans the bodies read: for each ``P`` of
    ``parts`` the partition and the overlapped halo plan, and the
    block-dense plan where ``parts[P]`` (``bd_kw`` passed to
    ``build_sharded_blockdense``). Returns the seconds of each stage and
    the plans, by P."""
    from sgc_tpu_torch.parallel.blockdense import build_sharded_blockdense
    from sgc_tpu_torch.parallel.distributed import save_host
    from sgc_tpu_torch.parallel.halo import build_halo

    plan_dir = Path(plan_dir)
    seconds, plans = {}, {}
    for P, with_bd in parts.items():
        t = [time.perf_counter()]
        pg = partition_graph(graph, P, device=False)
        t.append(time.perf_counter())
        ho = build_halo(pg, overlap=True, device=False)
        t.append(time.perf_counter())
        bd = (build_sharded_blockdense(pg, ho, device=False, **bd_kw)
              if with_bd else None)
        t.append(time.perf_counter())
        for name, obj in (("pgraph", pg), ("halo", ho), ("bd", bd)):
            if obj is not None:
                save_host(plan_dir / f"p{P}" / name, obj)
        t.append(time.perf_counter())
        seconds[P] = dict(zip(("partition_s", "halo_s", "blockdense_s",
                               "write_s"), np.diff(t).tolist()))
        plans[P] = (pg, ho, bd)
    return {"seconds": seconds, "plans": plans}


def blockdense_operator_vals(graph, pgraph, halo, bd):
    """The graph's values with every edge the block-dense plan admits into
    a cell rounded to bf16, as the cells store it: the operator the
    sharded block-dense hop computes."""
    vals = np.array(graph.vals[: graph.nnz], np.float32)
    R, W, RB = pgraph.rows_per_part, bd.stripe, bd.row_block
    n_st, n_st_loc = bd.t_pad // W, bd.r_up // W
    row_ptr = np.asarray(graph.row_ptr, np.int64)
    for p in range(pgraph.n_parts):
        # the part's edges are its rows' contiguous run of the row-sorted
        # graph, in the same order
        lo = row_ptr[min(p * R, graph.n_rows)]
        hi = row_ptr[min((p + 1) * R, graph.n_rows)]
        r = np.asarray(pgraph.rows_local[p][: hi - lo], np.int64)
        ch = np.asarray(halo.cols_halo[p][: hi - lo], np.int64)
        ct = np.where(ch < R, ch, ch - R + bd.r_up)
        ki, kb = int(bd.part_cells_int[p]), int(bd.part_cells_bnd[p])
        dense = np.concatenate([
            bd.rb_int[p, :ki].astype(np.int64) * n_st + bd.st_int[p, :ki],
            bd.rb_bnd[p, :kb].astype(np.int64) * n_st + bd.st_bnd[p, :kb]
            + n_st_loc])
        m = np.isin((r // RB) * n_st + ct // W, dense)
        v = vals[lo:hi]
        v[m] = torch.from_numpy(v[m]).to(torch.bfloat16).float().numpy()
    return vals


def load_plans(plan_dir: Path, n_parts: int):
    """(pgraph, overlapped halo, its single-exchange twin, block-dense
    plan or None) of ``p<n_parts>/``."""
    d = plan_dir / f"p{n_parts}"
    pg, ho = load_host(d / "pgraph"), load_host(d / "halo")
    bd = load_host(d / "bd") if (d / "bd").exists() else None
    return pg, ho, dataclasses.replace(ho, edges_int=None,
                                       edges_bnd=None), bd


def _error_text(fn) -> str:
    """``fn()``'s ValueError or AssertionError message ("" when it
    returns)."""
    try:
        fn()
    except (ValueError, AssertionError) as e:
        return str(e)
    return ""


def _train(mesh, pg, x, labels, idx_train, state, steps, **kw):
    """``steps`` sharded steps from ``state`` (reference arrays): the
    losses and the full W on every rank of ``mesh``."""
    st = sharded_state_from_jax(state, mesh)
    xs = shard_features(mesh, pad_node_rows(x, pg.n_rows_padded))
    y, m = place_node_targets(mesh, pg.n_rows_padded, labels, idx_train)
    step = make_sharded_train_step(mesh, pg, **kw)
    losses = []
    for _ in range(steps):
        st, loss = step(st, xs, y, m)
        losses.append(float(loss))
    w = fetch_global(mesh, st.params.w.detach(), (FEAT_AXIS, None))
    return {"losses": losses, "w": w,
            "b": st.params.b.detach().cpu().numpy()}


def sharded_checks(plan_dir: str, cfg: dict):
    """The CPU parity cases on 4 ranks over gloo (module docstring).
    ``cfg``: ``degree``, ``edge_chunk``, ``col_chunks``, ``fault``,
    ``train`` (a list of ``{name, mesh, n_parts, halo, steps, lr,
    weight_decay, state}``) and optionally ``short_dir``, the plans of a
    second graph whose every form runs on (4, 1) too.
    Rank 0 returns a dict; the others None."""
    plan_dir = Path(plan_dir)
    x = np.load(plan_dir / "x.npy")
    labels = np.load(plan_dir / "labels.npy")
    idx_train = np.load(plan_dir / "idx_train.npy")
    deg, ec = cfg["degree"], cfg["edge_chunk"]
    out = {"forms": {}, "errors": {}}

    runs = [((4, 1), plan_dir, x, ""), ((2, 2), plan_dir, x, "")]
    if cfg.get("short_dir"):
        # a graph whose last part is short and another empty
        short = Path(cfg["short_dir"])
        runs.append(((4, 1), short, np.load(short / "x.npy"), "short/"))
    for shape, pdir, xv, tag in runs:
        mesh = make_mesh(*shape, device="cpu")
        pg, ho, h, bd = load_plans(pdir, shape[0])
        xs = shard_features(mesh, pad_node_rows(xv, pg.n_rows_padded))
        forms = {"allgather": {}, "allgather_ec": {"edge_chunk": ec},
                 "halo": {"halo": h}, "halo_ec": {"halo": h,
                                                  "edge_chunk": ec},
                 "overlap": {"halo": ho}, "overlap_ec": {"halo": ho,
                                                         "edge_chunk": ec},
                 "blockdense": {"blockdense": bd, "precision": "f32"},
                 "blockdense_bf16": {"blockdense": bd,
                                     "precision": "bf16"}}
        for name, kw in forms.items():
            y = propagate_sharded(mesh, pg, xs, deg, **kw)
            out["forms"][f"{tag}{shape[0]}x{shape[1]}/{name}"] = (
                fetch_global(mesh, y))
        if tag:
            continue
        if shape == (2, 2):
            out["errors"]["col_chunk_feat"] = _error_text(
                lambda: propagate_sharded(mesh, pg, xs, 1, col_chunk=8))
            out["round_trips"] = _round_trips(mesh, pg.n_rows_padded,
                                              x.shape[1])
            continue
        # (4, 1): the memory controls, orders, checks and rejections
        same = {}
        for halo_arg, hname in ((None, "allgather"), (h, "halo"),
                                (ho, "overlap")):
            for e in (None, ec):
                ref = propagate_sharded(mesh, pg, xs, deg, halo=halo_arg,
                                        edge_chunk=e)
                for cc in cfg["col_chunks"]:
                    got = propagate_sharded(mesh, pg, xs, deg, halo=halo_arg,
                                            edge_chunk=e, col_chunk=cc,
                                            sync_each_hop=True)
                    same[f"{hname}/ec={e}/cc={cc}"] = torch.equal(got, ref)
        box = [xs]
        consumed = propagate_sharded(mesh, pg, box, deg, halo=h,
                                     col_chunk=cfg["col_chunks"][0])
        same["consume"] = box == [] and torch.equal(
            consumed, propagate_sharded(mesh, pg, xs, deg, halo=h,
                                        col_chunk=cfg["col_chunks"][0]))
        out["col_chunk_same_bits"] = same
        pg2 = load_host(plan_dir / "p2" / "pgraph")
        out["errors"].update({
            "consume_two": _error_text(
                lambda: propagate_sharded(mesh, pg, [xs, xs], 1)),
            "col_chunk_blockdense": _error_text(
                lambda: propagate_sharded(mesh, pg, xs, 1, blockdense=bd,
                                          col_chunk=8)),
            "edge_chunk_blockdense": _error_text(
                lambda: spmm_sharded(mesh, pg, xs, blockdense=bd,
                                     edge_chunk=ec)),
            "parts": _error_text(lambda: spmm_sharded(mesh, pg2, xs)),
            "nccl_on_cpu": _error_text(lambda: make_mesh(
                4, 1, device="cpu", transport="nccl")),
            "transport": _error_text(lambda: make_mesh(
                4, 1, device="cpu", transport="mpi")),
            "form": _error_text(lambda: spmm_sharded(
                mesh, pg, xs, blockdense=bd, form="einsum")),
        })
        events = []
        with trace_order(events):
            spmm_sharded(mesh, pg, xs, halo=ho)
            events.append("|")
            spmm_sharded(mesh, pg, xs, blockdense=bd, precision="f32")
        out["order"] = events
        out["deltas"] = validate_exchange(mesh, ho.send_idx, xs)
        out["errors"]["fault"] = _error_text(
            lambda: validate_exchange(mesh, ho.send_idx, xs,
                                      inject_fault=tuple(cfg["fault"])))
        assert_deterministic(lambda: spmm_sharded(
            mesh, pg, xs, blockdense=bd, precision="f32"))
        calls = []
        out["errors"]["deterministic"] = _error_text(
            lambda: assert_deterministic(
                lambda: xs + float(calls.append(1) or len(calls))))

    out["train"] = {}
    for t in cfg["train"]:
        mesh = make_mesh(*t["mesh"], device="cpu")
        if mesh is None:
            continue
        pg, ho, h, _ = load_plans(plan_dir, t["n_parts"])
        halo_arg = {"none": None, "halo": h, "overlap": ho}[t["halo"]]
        out["train"][t["name"]] = _train(
            mesh, pg, x, labels, idx_train, t["state"], t["steps"],
            degree=deg, lr=t["lr"], weight_decay=t["weight_decay"],
            halo=halo_arg)
    return out if torch.distributed.get_rank() == 0 else None


def _round_trips(mesh: Mesh, n_rows: int, f: int) -> dict:
    """put_global then fetch_global under every spec, on a value whose
    dims divide the mesh: True where the full value comes back."""
    v = np.arange(n_rows * f, dtype=np.float32).reshape(n_rows, f)
    out = {}
    for spec in (NODE_FEAT, (NODES_AXIS, None), (NODES_AXIS,),
                 (FEAT_AXIS, None), (None, FEAT_AXIS), ()):
        got = fetch_global(mesh, put_global(mesh, spec, v), spec)
        out[str(spec)] = bool(np.array_equal(got, v))
    return out


# ------------------------------------------------------------- the card


def held_hop_check(plan_dir: str, n_parts: int, precision: str) -> dict:
    """One block-dense hop on an ``(n_parts, 1)`` mesh with every kernel
    launch held against its plain version (``hold_launches``); returns
    the worst errors, the kernels held, the refusal of an NCCL mesh of
    ``n_parts`` ranks and, on every rank, the gathered output (the card
    test's body)."""
    plan_dir = Path(plan_dir)
    mesh = make_mesh(n_parts, 1)
    pg, _, _, bd = load_plans(plan_dir, n_parts)
    xs = shard_features(mesh, pad_node_rows(np.load(plan_dir / "x.npy"),
                                            pg.n_rows_padded))
    hop = spmm_sharded(mesh, pg, xs, blockdense=bd, precision=precision)
    record = []
    with hold_launches(record):
        held = spmm_sharded(mesh, pg, xs, blockdense=bd, precision=precision)
    # NCCL refuses two ranks of one communicator on one card
    too_many = _error_text(lambda: make_mesh(n_parts, 1, transport="nccl"))
    return {"worst": _worst(record), "same_bits": bool(torch.equal(held, hop)),
            "nccl_refused": too_many,
            "kernels": sorted({name for name, _, _ in record}),
            "out": fetch_global(mesh, hop), "device": str(mesh.device)}


def _timed(fn, device) -> tuple[float, object]:
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def _worst(record: list) -> dict:
    """The largest (max_abs_err, rel_err) per counter name."""
    worst = {}
    for name, a, r in record:
        pa, pr = worst.get(name, (0.0, 0.0))
        worst[name] = (max(pa, a), max(pr, r))
    return worst


def _form(mesh, pg, xs, kw, degree, tolerance, exchange, timed) -> tuple:
    """One form on this rank: a run with every kernel launch held against
    its plain version (the launch counters zeroed just before it and read
    just after; it also places the rank's view); with ``timed``, a timed
    run (the same bits) and ``exchange()`` timed alone."""
    dev = mesh.device
    record = []
    t0 = time.perf_counter()
    zero_counts()
    with hold_launches(record):
        y = propagate_sharded(mesh, pg, xs, degree, **kw)
    sync(dev)
    launches = read_counts(COUNTERS)
    sections = {"held_s": time.perf_counter() - t0}
    worst = _worst(record)
    for name, (_, r) in worst.items():
        if not r <= tolerance:
            raise AssertionError(f"{name} vs plain: rel err {r:.3e}")
    rec = {"hops_s": None, "exchange_ms": None, "launches": launches,
           "held_launches": len(record), "vs_plain": worst,
           "sections_s": sections}
    if timed:
        rec["hops_s"], again = _timed(
            lambda: propagate_sharded(mesh, pg, xs, degree, **kw), dev)
        if not torch.equal(again, y):
            raise AssertionError("the timed hops differ from the held hops")
        exchange_s, _ = _timed(exchange, dev)
        rec["exchange_ms"] = 1e3 * exchange_s
    return y, rec


def _ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``reps`` calls after a warm one: CUDA events
    on a card, the host clock closed by a sync elsewhere."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_times(mesh, local, xs, reps: int) -> dict:
    """This rank's kernel-A and kernel-B launches of one block-dense hop
    at "f32", each timed while every other rank waits at a barrier (no
    rank shares the card with another's timed launches), with the bounds
    of ``ops/roofline.py``."""
    from sgc_tpu_torch.ops.roofline import b_bound, kernel_a_bound
    from sgc_tpu_torch.ops.spmm_blockdense import n_passes

    dist = torch.distributed
    halo = mesh.all_to_all(NODES_AXIS, halo_mod.pack(xs, local.send_idx))
    dev, F = mesh.device, int(xs.shape[1])
    out = {}
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r != dist.get_rank():
            continue
        acc = None
        for side, split, args, x, rest in (
                ("interior", local.split_int, local.args_int, xs,
                 local.rest_int),
                ("boundary", local.split_bnd, local.args_bnd, halo,
                 local.rest_bnd)):
            dense = None
            if split is not None:
                dense = bd_ops.apply_cells(split, args, x, "f32")
                if acc is not None:
                    dense = dense + acc
                bound = kernel_a_bound(split, args, split.n_cells, F,
                                       n_passes("f32"))
                out[f"a_{side}"] = {
                    "cells": split.n_cells, "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"], "ms": _ms(
                        lambda: bd_ops.apply_cells(split, args, x, "f32"),
                        reps, dev)}
            else:
                dense = acc
            g = rest.graph
            bms, bby = b_bound(g, F, dense=dense is not None)
            out[f"b_{side}"] = {"nnz": g.nnz, "bound_ms": bms,
                                "bound_by": bby, "ms": _ms(
                                    lambda: spmm_ops.spmm_segment(g, x, dense),
                                    reps, dev)}
            acc = spmm_ops.spmm_segment(g, x, dense)
    dist.barrier()
    return out


def _against(y_full, ref_path, n_rows, tolerance, device) -> tuple:
    """(max_abs_err, rel_err) of the gathered rows against the reference
    file; the padding rows must be zero."""
    if np.any(y_full[n_rows:] != 0):
        raise AssertionError("padding rows are not zero")
    got = torch.as_tensor(y_full[:n_rows], device=device)
    want = torch.as_tensor(np.load(ref_path), device=device)
    err = rel_err(got, want)
    if not err[1] <= tolerance:
        raise AssertionError(f"gathered hops vs {Path(ref_path).name}: rel "
                             f"err {err[1]:.3e} > {tolerance}")
    return err


def smoke_world(plan_dir: str, cfg: dict) -> dict:
    """The chip smoke's 4-rank body (gloo, every rank on the card): once
    ``plan_dir/ready`` exists, the forms of ``cfg["forms"]`` on meshes
    (4, 1) and (2, 2), each launch held, gathered and held against the
    reference files; col_chunk's bits; validate_exchange clean and
    faulted; assert_deterministic on the block-dense hop;
    ``cfg["steps"]`` train steps on (2, 2) (the P = 2 overlapped halo
    plan) against (1, 1) (P = 1); measure_spmm_scaling. Every rank
    returns its numbers; rank 0 adds the gathered errors, the train
    parity and the scaling report."""
    t_start, started_unix = time.perf_counter(), time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    plan_dir = Path(plan_dir)
    # the ranks start while the plans are written: wait for the marker
    while not (plan_dir / "ready").exists():
        if (plan_dir / "abort").exists():
            raise RuntimeError("the parent stopped before the plans were "
                               "ready")
        time.sleep(0.05)
    t_ready = time.perf_counter()
    x = np.load(plan_dir / "x.npy", mmap_mode="r")
    n_rows, deg = x.shape[0], cfg["degree"]
    rank0 = torch.distributed.get_rank() == 0
    out = {"forms": {}, "gathered": {}, "started_unix": started_unix}
    plans = {P: load_plans(plan_dir, P) for P in (4, 2)}
    dev = cfg.get("device")        # None: each rank's card
    meshes = {s: make_mesh(*s, device=dev) for s in ((4, 1), (2, 2))}
    out["sections_s"] = {"wait_s": t_ready - t_start,
                         "start_s": time.perf_counter() - t_ready}
    for form in cfg["forms"]:
        t_form = time.perf_counter()
        mesh = meshes[tuple(form["mesh"])]
        pg, ho, h, bd = plans[form["mesh"][0]]
        kw = {"overlap": {"halo": ho}, "halo": {"halo": h}, "allgather": {},
              "blockdense": {"blockdense": bd}}[form["plan"]]
        kw.update(form.get("kw", {}))
        xs = shard_features(mesh, pad_node_rows(x, pg.n_rows_padded))
        if form["plan"] == "allgather":
            def exchange():
                return mesh.all_gather(NODES_AXIS, xs)
        else:
            send = torch.as_tensor(np.asarray(
                ho.send_idx[mesh.coords[NODES_AXIS]]).reshape(-1).astype(
                    np.int64), device=mesh.device)

            def exchange():
                return mesh.all_to_all(NODES_AXIS, halo_mod.pack(xs, send))
        y, rec = _form(mesh, pg, xs, kw, deg, cfg["tolerance"], exchange,
                       form["timed"])
        out["forms"][form["name"]] = rec
        if form.get("same_bits_as"):
            out["forms"][form["name"]]["same_bits"] = bool(torch.equal(
                y, out.pop("_y_" + form["same_bits_as"])))
        if form.get("keep"):
            out["_y_" + form["name"]] = y
        t0 = time.perf_counter()
        y_full = fetch_global(mesh, y)
        rec["sections_s"]["fetch_s"] = time.perf_counter() - t0
        if rank0:
            out["gathered"][form["name"]] = _against(
                y_full, plan_dir / form["ref"], n_rows, form["ref_tolerance"],
                mesh.device)
        rec["sections_s"]["form_s"] = time.perf_counter() - t_form
        del y, y_full, xs

    t0 = time.perf_counter()
    mesh = meshes[(4, 1)]
    pg, ho, _, bd = plans[4]
    xs = shard_features(mesh, pad_node_rows(x, pg.n_rows_padded))
    out["kernels"] = _kernel_times(
        mesh, local_view("blockdense", mesh, pg, bd), xs, cfg["reps"])
    out["deltas_max"] = float(validate_exchange(mesh, ho.send_idx, xs).max())
    out["fault"] = _error_text(lambda: validate_exchange(
        mesh, ho.send_idx, xs, inject_fault=(1, 2)))
    if "halo exchange corruption" not in out["fault"]:
        raise AssertionError(f"injected fault not caught: {out['fault']!r}")
    assert_deterministic(lambda: spmm_sharded(mesh, pg, xs, blockdense=bd,
                                              precision="f32"))
    del xs
    out["sections_s"]["checks_s"] = time.perf_counter() - t0

    labels = np.load(plan_dir / "labels.npy")
    idx_train = np.load(plan_dir / "idx_train.npy")
    pg2, ho2, _, _ = plans[2]
    kw = {"degree": deg, "lr": cfg["lr"], "weight_decay": cfg["weight_decay"]}
    t0 = time.perf_counter()
    sharded = _train(meshes[(2, 2)], pg2, x, labels, idx_train, cfg["state"],
                     cfg["steps"], halo=ho2, **kw)
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = make_mesh(1, 1, device=dev)
    if one is not None:
        pg1, ho1, _, _ = load_plans(plan_dir, 1)
        single = _train(one, pg1, x, labels, idx_train, cfg["state"],
                        cfg["steps"], halo=ho1, **kw)
        out["train"] = _train_parity(sharded, single)
    out["sections_s"]["train_1x1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    from sgc_tpu_torch.parallel.scaling import measure_spmm_scaling

    report = measure_spmm_scaling(load_host(plan_dir / "graph"), x,
                                  n_devices=4, hops=deg,
                                  repeats=cfg["scaling_repeats"], device=dev)
    out["scaling"] = dataclasses.asdict(report)
    out["scaling_line"] = str(report)
    out["sections_s"]["scaling_s"] = time.perf_counter() - t0
    return out


def _train_parity(sharded: dict, single: dict) -> dict:
    """The reference's tolerances (rtol 1e-4 on the losses; rtol 1e-3,
    atol 1e-5 on W); raises when they fail."""
    ls, l1 = np.asarray(sharded["losses"]), np.asarray(single["losses"])
    loss_rel = float(np.max(np.abs(ls - l1) / np.abs(l1)))
    w_excess = float(np.max(np.abs(sharded["w"] - single["w"])
                            - (1e-5 + 1e-3 * np.abs(single["w"]))))
    if not (loss_rel <= 1e-4 and w_excess <= 0.0):
        raise AssertionError(f"sharded train step vs (1, 1): loss rel "
                             f"{loss_rel:.3e}, W over tolerance by "
                             f"{w_excess:.3e}")
    return {"losses": sharded["losses"], "losses_1x1": single["losses"],
            "loss_max_rel": loss_rel,
            "w_max_abs": float(np.abs(sharded["w"] - single["w"]).max()),
            "finite": bool(np.isfinite(sharded["w"]).all())}


def smoke_world_of_one(plan_dir: str, cfg: dict) -> dict:
    """The chip smoke's 1-rank body (an NCCL world): one block-dense hop
    and one train step on a (1, 1) NCCL mesh, bit-equal to the same calls
    on a (1, 1) gloo mesh of the same process (the plans built here,
    P = 1, at the committed admission)."""
    from sgc_tpu_torch.parallel.blockdense import build_sharded_blockdense
    from sgc_tpu_torch.parallel.halo import build_halo

    torch.backends.cuda.matmul.allow_tf32 = False
    plan_dir = Path(plan_dir)
    x = np.load(plan_dir / "x.npy", mmap_mode="r")
    labels = np.load(plan_dir / "labels.npy")
    idx_train = np.load(plan_dir / "idx_train.npy")
    t0 = time.perf_counter()
    pg = partition_graph(load_host(plan_dir / "graph"), 1, device=False)
    ho = build_halo(pg, overlap=True, device=False)
    bd = build_sharded_blockdense(pg, ho, x.shape[1], device=False)
    plan_s = time.perf_counter() - t0
    out = {"plan_s": plan_s, "n_cells": bd.n_cells}
    runs = []
    for transport in cfg.get("transports", ("nccl", "gloo")):
        mesh = make_mesh(1, 1, device=cfg.get("device"), transport=transport)
        xs = shard_features(mesh, pad_node_rows(x, pg.n_rows_padded))
        spmm_sharded(mesh, pg, xs, blockdense=bd, precision="f32")
        zero_counts()
        hop_s, y = _timed(lambda: spmm_sharded(
            mesh, pg, xs, blockdense=bd, precision="f32"), mesh.device)
        launches = read_counts(COUNTERS)
        tr = _train(mesh, pg, x, labels, idx_train, cfg["state"], 1,
                    degree=cfg["degree"], lr=cfg["lr"],
                    weight_decay=cfg["weight_decay"], halo=ho)
        runs.append((y, tr))
        out[transport] = {"hop_s": hop_s, "launches": launches,
                          "loss": tr["losses"][0]}
    (yn, tn), (yg, tg) = runs
    out["same_bits"] = {
        "hop": bool(torch.equal(yn, yg)),
        "train": bool(tn["losses"] == tg["losses"]
                      and np.array_equal(tn["w"], tg["w"])
                      and np.array_equal(tn["b"], tg["b"]))}
    if not all(out["same_bits"].values()):
        raise AssertionError(f"NCCL and gloo (1, 1) differ: "
                             f"{out['same_bits']}")
    return out


# --------------------------------------------------- the entry points' worlds


def _world() -> int:
    return torch.distributed.get_world_size()


def _cli_inputs(root: Path):
    graph = load_host(root / "graph")
    x = np.load(root / "x.npy", mmap_mode="r")
    return graph, x, np.load(root / "labels.npy"), np.load(
        root / "idx_train.npy")


def cli_sgc(root: str, cfg: dict):
    """``cli.citation --sharded`` for SGC: ``fit_sharded`` on the world's
    default mesh with ``cfg["kw"]``; rank 0 returns the head and the
    report."""
    from sgc_tpu_torch.parallel.fit import fit_sharded
    from sgc_tpu_torch.parallel.mesh import default_mesh_shape

    graph, x, labels, idx_train = _cli_inputs(Path(root))
    mesh = make_mesh(*default_mesh_shape(_world()), device=cfg.get("device"))
    params, report = fit_sharded(graph, x, labels, idx_train,
                                 cfg["n_classes"], mesh=mesh, **cfg["kw"])
    if mesh.rank:
        return None
    return {"w": params.w.cpu().numpy(), "b": params.b.cpu().numpy(),
            "report": dataclasses.asdict(report)}


def cli_gcn(root: str, cfg: dict):
    """``cli.citation --sharded`` for GCN: ``fit_gcn_sharded`` on every
    rank of the world on "nodes"; rank 0 returns the params and the
    losses."""
    from sgc_tpu_torch.parallel.gcn import PARAMS, fit_gcn_sharded

    graph, x, labels, idx_train = _cli_inputs(Path(root))
    mesh = make_mesh(_world(), 1, device=cfg.get("device"))
    model, losses = fit_gcn_sharded(graph, x, labels, idx_train,
                                    cfg["n_classes"], mesh=mesh,
                                    **cfg["kw"])
    if mesh.rank:
        return None
    return {"params": {k: getattr(model, k).cpu().numpy() for k in PARAMS},
            "losses": losses}


def cli_reddit(root: str, cfg: dict):
    """``cli.reddit --sharded``: the sharded propagation over every rank
    of the world (transductive: the full graph; ``cfg["inductive"]``: the
    dual propagation of ``parallel/inductive.py``), ``cfg["formulation"]``
    "segment" or "blockdense". Rank 0 writes the gathered eval rows (and
    train rows) to ``eval.npy`` (``train.npy``) and returns the slowest
    rank's seconds."""
    from sgc_tpu_torch.parallel.blockdense import build_sharded_blockdense
    from sgc_tpu_torch.parallel.halo import build_halo
    from sgc_tpu_torch.parallel.inductive import (
        build_dual_partition,
        inductive_dual_propagate,
    )

    root = Path(root)
    graph, x, _, idx_train = _cli_inputs(root)
    P, deg, form = _world(), cfg["degree"], cfg["formulation"]
    mesh = make_mesh(P, 1, device=cfg.get("device"))
    dev = mesh.device
    if cfg["inductive"]:
        dual = build_dual_partition(
            graph, load_host(root / "train_graph"), idx_train, P,
            formulation=form, n_features=int(x.shape[1]))
        sync(dev)
        t0 = time.perf_counter()
        ev, tr = inductive_dual_propagate(mesh, dual, x, deg)
        sync(dev)
        seconds = time.perf_counter() - t0
        out = {"eval": (ev, graph.n_rows), "train": (tr, len(idx_train))}
    else:
        pg = partition_graph(graph, P, device=False)
        halo = build_halo(pg, device=False)
        bd = (build_sharded_blockdense(pg, halo, int(x.shape[1]),
                                       device=False)
              if form == "blockdense" else None)
        sync(dev)
        t0 = time.perf_counter()
        xs = shard_features(mesh, pad_node_rows(x, pg.n_rows_padded))
        ev = propagate_sharded(mesh, pg, xs, deg, halo=halo, blockdense=bd)
        sync(dev)
        seconds = time.perf_counter() - t0
        out = {"eval": (ev, graph.n_rows)}
    slowest = float(mesh.all_reduce(
        NODES_AXIS, torch.tensor([seconds], dtype=torch.float64,
                                 device=dev), op="max"))
    for name, (tile, n) in out.items():
        full = fetch_global(mesh, tile)
        if mesh.rank == 0:
            np.save(root / f"{name}.npy", full[:n])
    return {"seconds": slowest} if mesh.rank == 0 else None


def cli_scaling(root: str, cfg: dict):
    """``cli.scaling`` at one rank count (the world's): the scaling
    report, and on rank 0 the comm model."""
    from sgc_tpu_torch.parallel.scaling import comm_model, measure_spmm_scaling

    root = Path(root)
    graph = load_host(root / "graph")
    x = np.load(root / "x.npy")
    rep = measure_spmm_scaling(graph, x, n_devices=_world(),
                               hops=cfg["hops"], repeats=cfg["repeats"],
                               device=cfg.get("device"))
    if torch.distributed.get_rank():
        return None
    return {"report": dataclasses.asdict(rep),
            "comm_model": comm_model(graph, x.shape[1], rep.n_devices,
                                     rep.single_rate, build_plan=False)}


def cli_dist_demo(cfg: dict):
    """``cli.dist_demo``'s fit on the world (the reference's mesh rule);
    rank 0 returns its summary."""
    from sgc_tpu_torch.cli.dist_demo import run_fit

    out = run_fit(cfg)
    return out if torch.distributed.get_rank() == 0 else None


# ------------------------------------------ distributed training (CPU tests)


class RecordingRows:
    """A row provider over an array that records every ``(start, stop)``
    it is asked for (``parallel/staging.py``)."""

    def __init__(self, arr):
        self._arr = np.asarray(arr)
        self.shape = self._arr.shape
        self.dtype = self._arr.dtype
        self.calls = []

    def __call__(self, start, stop):
        self.calls.append((int(start), int(stop)))
        return self._arr[start:stop]


def staging_checks(root: str, cfg: dict) -> dict:
    """Every rank: ``stage_rows`` against ``shard_features`` of the padded
    full matrix on meshes (4, 1) and (2, 2) (with the provider's calls and
    the sharding report), and the train state saved by ``save_sharded``
    on (4, 1) restored by ``load_sharded`` onto (2, 2) and to the host."""
    from sgc_tpu_torch.parallel.staging import sharding_report, stage_rows
    from sgc_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    root = Path(root)
    x = np.load(root / "x.npy")
    n_pad = cfg["n_rows_padded"]
    out = {"stage": {}}
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(*shape, device="cpu")
        prov = RecordingRows(x)
        tile = stage_rows(mesh, prov, n_rows_padded=n_pad)
        full = np.zeros((n_pad, -(-x.shape[1] // (8 * shape[1]))
                         * 8 * shape[1]), np.float32)
        full[: x.shape[0], : x.shape[1]] = x
        out["stage"][f"{shape[0]}x{shape[1]}"] = {
            "equal": bool(torch.equal(tile, shard_features(mesh, full))),
            "calls": prov.calls, "gathered": fetch_global(mesh, tile),
            "report": sharding_report(mesh, tile)}
    state = {k: np.asarray(v) for k, v in cfg["state"].items()}
    specs = cfg["specs"]
    m41, m22 = (make_mesh(*s, device="cpu") for s in ((4, 1), (2, 2)))
    save_sharded(root / "ck", {k: put_global(m41, specs.get(k, ()), v)
                               for k, v in state.items()}, m41, specs)
    like = {k: torch.zeros_like(put_global(m22, specs.get(k, ()), v))
            for k, v in state.items()}
    got = load_sharded(root / "ck", like=like, mesh=m22)
    out["restored_2x2"] = all(
        torch.equal(got[k], put_global(m22, specs.get(k, ()), v))
        for k, v in state.items())
    out["restored_host"] = {k: v for k, v in load_sharded(root / "ck").items()}
    return out


GRAD_FORMS = ("allgather", "allgather_ec", "halo", "halo_ec", "overlap",
              "overlap_ec", "blockdense", "blockdense_bf16")


def _grad_forms(h, ho, bd, ec) -> dict:
    return {"allgather": {}, "allgather_ec": {"edge_chunk": ec},
            "halo": {"halo": h}, "halo_ec": {"halo": h, "edge_chunk": ec},
            "overlap": {"halo": ho},
            "overlap_ec": {"halo": ho, "edge_chunk": ec},
            "blockdense": {"blockdense": bd, "precision": "f32"},
            "blockdense_bf16": {"blockdense": bd, "precision": "bf16"}}


def sharded_grad(mesh, pg, xs, gs, degree, **kw) -> torch.Tensor:
    """The gradient of ``<propagate_sharded(x), g>`` at this rank's x."""
    x = xs.detach().clone().requires_grad_(True)
    y = propagate_sharded(mesh, pg, x, degree, **kw)
    (gx,) = torch.autograd.grad(y, x, gs)
    return gx


def _padded_slots_zero(mesh, pg, h, gs) -> dict:
    """Whether the transposed gather table leaves exact zeros in the
    received block's padded slots (no edge references them), so that they
    carry zeros back; and how many padded slots were looked at."""
    from sgc_tpu_torch.parallel.halo import pair_width_matrix

    R, H, P = pg.rows_per_part, h.halo_width, pg.n_parts
    me = mesh.coords[NODES_AXIS]
    t = local_view("halo_t", mesh, pg, h)
    g_cat = halo_mod.segment_spmm(t.table, gs)
    widths = pair_width_matrix(pg)[me]
    pad = [R + q * H + s for q in range(P) for s in range(widths[q], H)]
    back = mesh.all_to_all(NODES_AXIS, g_cat[R:])
    widths_to = pair_width_matrix(pg)[:, me]
    pad_back = [q * H + s for q in range(P) for s in range(widths_to[q], H)]
    return {"zero": bool((g_cat[pad] == 0).all()
                         and (back[pad_back] == 0).all()),
            "slots": len(pad) + len(pad_back)}


def grad_checks(plan_dir: str, cfg: dict) -> dict:
    """Rank 0 returns, for every form of ``GRAD_FORMS`` on meshes (4, 1)
    and (2, 2) (and (4, 1) of the short graph under ``cfg["short_dir"]``),
    the gathered gradient of ``<S^K x, g>`` (``g.npy``), whether a second
    backward gave the same bits, col_chunk's backward against the
    unpaneled one, and the padded-slot check."""
    plan_dir = Path(plan_dir)
    deg, ec = cfg["degree"], cfg["edge_chunk"]
    out = {"grads": {}, "same_bits": {}}
    runs = [((4, 1), plan_dir, ""), ((2, 2), plan_dir, "")]
    if cfg.get("short_dir"):
        runs.append(((4, 1), Path(cfg["short_dir"]), "short/"))
    for shape, pdir, tag in runs:
        mesh = make_mesh(*shape, device="cpu")
        pg, ho, h, bd = load_plans(pdir, shape[0])
        xs, gs = (shard_features(mesh, pad_node_rows(
            np.load(pdir / f), pg.n_rows_padded)) for f in ("x.npy",
                                                            "g.npy"))
        for name, kw in _grad_forms(h, ho, bd, ec).items():
            key = f"{tag}{shape[0]}x{shape[1]}/{name}"
            gx = sharded_grad(mesh, pg, xs, gs, deg, **kw)
            again = sharded_grad(mesh, pg, xs, gs, deg, **kw)
            out["same_bits"][key] = bool(torch.equal(gx, again))
            out["grads"][key] = fetch_global(mesh, gx)
        if shape == (4, 1) and not tag:
            ref = sharded_grad(mesh, pg, xs, gs, deg, halo=h)
            out["col_chunk_same_bits"] = bool(torch.equal(
                sharded_grad(mesh, pg, xs, gs, deg, halo=h,
                             col_chunk=cfg["col_chunk"]), ref))
            out["padded_slots_zero"] = _padded_slots_zero(mesh, pg, h, gs)
    return out if torch.distributed.get_rank() == 0 else None


def _warned(fn) -> tuple:
    """``(fn(), the messages of the warnings it raised)``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = fn()
    return got, [str(w.message) for w in caught]


def _fit_summary(params, report, feats=None) -> dict:
    out = {"w": params.w.cpu().numpy(), "b": params.b.cpu().numpy(),
           "report": dataclasses.asdict(report)}
    if isinstance(feats, RecordingRows):
        out["calls"] = feats.calls
    return out


def fit_checks(root: str, cfg: dict):
    """``fit_sharded`` on a 4-rank world: every case of ``cfg["fits"]``
    (``name``, ``mesh``, ``graph`` subdirectory, ``n_classes``, ``kw``,
    optional ``staged`` and ``init_state``), a checkpointed fit resumed
    against an uninterrupted one (``cfg["resume"]``), the checkpoint
    safety sequence (``cfg["safety"]``) and the reference's
    ``ValueError``s. Every rank returns its results (a staged fit's
    provider calls differ by rank)."""
    from sgc_tpu_torch.parallel.fit import fit_sharded, plan_fit

    root = Path(root)
    meshes = {s: make_mesh(*s, device="cpu") for s in ((4, 1), (2, 2))}
    out = {"fits": {}, "errors": {}}

    def run(case, **extra):
        graph, x, labels, idx = _cli_inputs(root / case["graph"])
        feats = RecordingRows(x) if case.get("staged") else np.asarray(x)
        params, report = fit_sharded(
            graph, feats, labels, idx, case["n_classes"],
            mesh=meshes[tuple(case["mesh"])],
            init_state=case.get("init_state"), **{**case["kw"], **extra})
        return _fit_summary(params, report, feats)

    for case in cfg["fits"]:
        out["fits"][case["name"]] = run(case)

    case = cfg["resume"]
    ck = str(root / "ck_resume")
    full = run(case)
    run(case, checkpoint_dir=ck, epochs=case["kw"]["epochs"] // 2)
    resumed = run(case, checkpoint_dir=ck)
    out["resume"] = {
        "n_losses": len(resumed["report"]["loss_history"]),
        "losses_equal": resumed["report"]["loss_history"]
        == full["report"]["loss_history"],
        "w_equal": bool(np.array_equal(resumed["w"], full["w"])),
        "b_equal": bool(np.array_equal(resumed["b"], full["b"])),
        "first_half_saved": (Path(ck) / "meta.json").exists()}

    case = cfg["safety"]
    ck = str(root / "ck_safety")
    mesh = meshes[tuple(case["mesh"])]
    run(case, checkpoint_dir=ck)
    safety = {}
    got, safety["mismatch"] = _warned(
        lambda: run(case, checkpoint_dir=ck, lr=case["kw"]["lr"] / 2))
    safety["mismatch_losses"] = len(got["report"]["loss_history"])
    mesh.barrier()
    if mesh.rank == 0:
        (Path(ck) / "meta.json").write_text("{not json")
    mesh.barrier()
    got, safety["garbled"] = _warned(lambda: run(case, checkpoint_dir=ck))
    safety["garbled_losses"] = len(got["report"]["loss_history"])
    got, safety["beyond"] = _warned(
        lambda: run(case, checkpoint_dir=ck, epochs=case["kw"]["epochs"]
                    // 2))
    safety["beyond_losses"] = len(got["report"]["loss_history"])
    out["safety"] = safety

    graph, x, labels, idx = _cli_inputs(root / case["graph"])
    mesh = meshes[(4, 1)]
    plan = plan_fit(graph, 4, 1, x.shape[1])
    out["errors"] = {
        "reorder_provider": _error_text(lambda: fit_sharded(
            graph, RecordingRows(x), labels, idx, 4, mesh=mesh,
            reorder="lpa")),
        "newton_checkpoint": _error_text(lambda: fit_sharded(
            graph, x, labels, idx, 4, mesh=mesh, trainer="newton",
            checkpoint_dir=str(root / "nope"))),
        "formulation": _error_text(lambda: fit_sharded(
            graph, x, labels, idx, 4, mesh=mesh, formulation="dense")),
        "trainer": _error_text(lambda: fit_sharded(
            graph, x, labels, idx, 4, mesh=mesh, trainer="sgd")),
        "plan_reorder": _error_text(lambda: fit_sharded(
            graph, x, labels, idx, 4, mesh=mesh, reorder="lpa",
            plan=plan)),
        "plan_parts": _error_text(lambda: fit_sharded(
            graph, x, labels, idx, 4, mesh=meshes[(2, 2)], plan=plan)),
    }
    return out


def gcn_checks(root: str, cfg: dict):
    """The sharded GCN on a 4-rank world: ``fit_gcn_sharded`` on (4, 1)
    from ``cfg["init"]`` (the halo plan, and the all-gather), steps of
    ``make_sharded_gcn_step`` through the halo plan and the block-dense
    plan (``p4/`` plans, ``cfg["bd"]`` precision), each step's parameter
    gradients summed over "nodes", and the ("nodes", 1) errors. Rank 0
    returns the results."""
    from sgc_tpu_torch.parallel.gcn import (
        PARAMS,
        ShardedGCNState,
        fit_gcn_sharded,
        gcn_apply_sharded,
        make_sharded_gcn_step,
    )
    from sgc_tpu_torch.models.gcn import params_from_jax

    import types

    root = Path(root)
    graph, x, labels, idx = _cli_inputs(root)
    mesh = make_mesh(4, 1, device="cpu")
    out = {}
    kw = cfg["fit"]
    for name, use_halo in (("halo", True), ("allgather", False)):
        model, losses = fit_gcn_sharded(graph, x, labels, idx,
                                        cfg["n_classes"], mesh=mesh,
                                        init_params=cfg["init"],
                                        use_halo=use_halo, **kw)
        out[f"fit_{name}"] = {"losses": losses, "params": {
            k: getattr(model, k).cpu().numpy() for k in PARAMS}}

    pg, ho, h, bd = load_plans(root, 4)
    xs = shard_features(mesh, pad_node_rows(x, pg.n_rows_padded))
    from sgc_tpu_torch.parallel.train import place_node_targets

    y, m = place_node_targets(mesh, pg.n_rows_padded, labels, idx)
    for name, plan in (("halo", {"halo": h}),
                       ("blockdense", {"blockdense": bd,
                                       "precision": cfg["precision"]})):
        state = ShardedGCNState(
            params_from_jax(types.SimpleNamespace(**cfg["init"]),
                            device="cpu"), {k: {} for k in PARAMS})
        step = make_sharded_gcn_step(mesh, pg, lr=kw["lr"],
                                     weight_decay=kw["weight_decay"],
                                     **plan)
        losses = []
        for _ in range(cfg["steps"]):
            state, loss = step(state, xs, y, m)
            losses.append(float(loss))
        out[f"step_{name}"] = {"losses": losses, "params": {
            k: getattr(state.params, k).detach().cpu().numpy()
            for k in PARAMS}}
    m22 = make_mesh(2, 2, device="cpu")
    out["errors"] = {
        "apply": _error_text(lambda: gcn_apply_sharded(
            m22, pg, state.params, xs)),
        "step": _error_text(lambda: make_sharded_gcn_step(m22, pg)),
        "fit": _error_text(lambda: fit_gcn_sharded(
            graph, x, labels, idx, cfg["n_classes"], mesh=m22)),
    }
    return out if mesh.rank == 0 else None


def inductive_checks(root: str, cfg: dict):
    """``inductive_dual_propagate`` on (4, 1) and (2, 2), segment and
    block-dense (``cfg["bd"]`` keywords); rank 0 returns the gathered eval
    and train rows, padding included."""
    from sgc_tpu_torch.parallel.inductive import (
        build_dual_partition,
        inductive_dual_propagate,
    )

    root = Path(root)
    full = load_host(root / "graph")
    train = load_host(root / "train_graph")
    x = np.load(root / "x.npy")
    idx = np.load(root / "idx_train.npy")
    out = {}
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(*shape, device="cpu")
        for form, kw in (("segment", {}), ("blockdense", cfg["bd"])):
            dual = build_dual_partition(full, train, idx, shape[0],
                                        formulation=form, **kw)
            ev, tr = inductive_dual_propagate(mesh, dual, x, cfg["degree"])
            out[f"{shape[0]}x{shape[1]}/{form}"] = (
                fetch_global(mesh, ev), fetch_global(mesh, tr))
    return out if torch.distributed.get_rank() == 0 else None


# ------------------------------------------ distributed training (the card)


def held_gcn_step(mesh, pg, plan: dict, state, xs, y, m) -> dict:
    """The loss and parameter gradients of one sharded GCN step through
    ``plan`` (``spmm_sharded`` keywords) with every kernel A and B launch,
    forward and backward, held against its plain version on its own
    inputs; the launch counters zeroed just before and read just after.
    Returns the worst errors of each direction, the held launch counts,
    the launches and the gradients."""
    import torch.nn.functional as F

    from sgc_tpu_torch.parallel.gcn import PARAMS, gcn_apply_sharded

    params = [getattr(state.params, k) for k in PARAMS]
    with torch.no_grad():
        denom = mesh.all_reduce(NODES_AXIS, m.sum())
    record = []
    zero_counts()
    with hold_launches(record):
        logits = gcn_apply_sharded(mesh, pg, state.params, xs, **plan)
        n_fwd = len(record)
        local = (F.cross_entropy(logits, y, reduction="none") * m).sum()
        grads = torch.autograd.grad(local / denom, params)
    sync(mesh.device)
    return {"forward": _worst(record[:n_fwd]),
            "backward": _worst(record[n_fwd:]),
            "held": {"forward": n_fwd, "backward": len(record) - n_fwd},
            "launches": read_counts(COUNTERS), "grads": grads}


def held_gcn_step_check(plan_dir: str, n_parts: int, precision: str,
                        seed: int = 0) -> dict:
    """One GCN step (hidden 16) through the block-dense plan of
    ``p<n_parts>/`` on an ``(n_parts, 1)`` mesh with every launch held
    (:func:`held_gcn_step`), then the same step again: whether its
    gradients came out bit for bit (the card test's body)."""
    from sgc_tpu_torch.parallel.gcn import init_sharded_gcn
    from sgc_tpu_torch.parallel.train import place_node_targets

    plan_dir = Path(plan_dir)
    mesh = make_mesh(n_parts, 1)
    pg, _, _, bd = load_plans(plan_dir, n_parts)
    x = np.load(plan_dir / "x.npy")
    labels = np.load(plan_dir / "labels.npy")
    idx = np.load(plan_dir / "idx_train.npy")
    xs = shard_features(mesh, pad_node_rows(x, pg.n_rows_padded))
    y, m = place_node_targets(mesh, pg.n_rows_padded, labels, idx)
    state = init_sharded_gcn(mesh, torch.Generator().manual_seed(seed),
                             x.shape[1], 16, int(labels.max()) + 1)
    plan = {"blockdense": bd, "precision": precision}
    out = held_gcn_step(mesh, pg, plan, state, xs, y, m)
    again = held_gcn_step(mesh, pg, plan, state, xs, y, m)
    out["same_bits"] = all(torch.equal(a, b) for a, b in
                           zip(out.pop("grads"), again["grads"]))
    out["device"] = str(mesh.device)
    return out


def _backward_kernel_times(mesh, pg, bd, F: int, reps: int) -> dict:
    """This rank's backward kernels of one block-dense hop at width F
    (``"f32"``): kernel A over the transposed interior and boundary
    cells, kernel B over the transposed remainders and the send scatter,
    each timed while the other ranks wait at a barrier, with its bound;
    and the bytes of the transposed cells."""
    from sgc_tpu_torch.ops.roofline import b_bound, kernel_a_bound
    from sgc_tpu_torch.ops.spmm_blockdense import n_passes

    dist = torch.distributed
    t = local_view("blockdense_t", mesh, pg, bd)
    dev = mesh.device
    g = torch.randn((pg.rows_per_part, F), generator=torch.Generator(
        ).manual_seed(mesh.rank)).to(dev)
    g_halo = torch.randn((bd.n_parts * bd.halo_width, F)).to(dev)
    out = {"transposed_cell_bytes": sum(
        int(c[1].cells.numel()) * 2 for c in (t.cells_int, t.cells_bnd)
        if c is not None)}
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r != dist.get_rank():
            continue
        for side, cells in (("interior", t.cells_int),
                            ("boundary", t.cells_bnd)):
            if cells is None:
                continue
            split, args = cells
            bound = kernel_a_bound(split, args, split.n_cells, F,
                                   n_passes("f32"))
            out[f"a_t_{side}"] = {
                "cells": split.n_cells, "F": F, "bound_ms":
                bound["bound_ms"], "bound_by": bound["bound_by"],
                "ms": _ms(lambda: bd_ops.apply_cells(split, args, g, "f32"),
                          reps, dev)}
        for name, csr, x in (("b_t_interior", t.interior, g),
                             ("b_t_boundary", t.boundary, g),
                             ("b_scatter", t.scatter, g_halo)):
            gr = csr.graph
            bms, bby = b_bound(gr, F)
            out[name] = {"nnz": gr.nnz, "F": F, "bound_ms": bms,
                         "bound_by": bby, "ms": _ms(
                             lambda: spmm_ops.spmm_segment(gr, x), reps,
                             dev)}
    dist.barrier()
    return out


def _part(out: dict, name: str, t0: float, **extra) -> None:
    """Close a smoke part: its seconds and this rank's launches since the
    counters were zeroed."""
    out["parts"][name] = {"seconds": time.perf_counter() - t0,
                          "launches": read_counts(COUNTERS), **extra}


def _training_fits(root: Path, cfg: dict, mesh, out: dict) -> None:
    """The smoke's ``fit_sharded`` part on this rank (see
    :func:`smoke_training_world`)."""
    import tracemalloc

    from sgc_tpu_torch.parallel.fit import fit_sharded, load_fit_plan
    from sgc_tpu_torch.parallel.staging import mmap_rows, stage_rows
    from sgc_tpu_torch.train.loops import _newton_linear_fit

    graph, x, labels, idx = _cli_inputs(root)
    n_classes = int(labels.max()) + 1
    plan = load_fit_plan(root / "fit22")
    kw = dict(mesh=mesh, degree=cfg["degree"], epochs=cfg["epochs"],
              lr=cfg["lr"], weight_decay=cfg["weight_decay"],
              seed=cfg["seed"], plan=plan)
    t0 = time.perf_counter()
    zero_counts()
    full = _fit_summary(*fit_sharded(graph, x, labels, idx, n_classes, **kw))
    fit_s = [time.perf_counter() - t0]
    ck = str(root / "fit_ckpt")
    half = cfg["save_every"]
    fit_sharded(graph, x, labels, idx, n_classes, checkpoint_dir=ck,
                save_every=half, **{**kw, "epochs": half})
    fit_s.append(time.perf_counter() - t0 - sum(fit_s))
    resumed = _fit_summary(*fit_sharded(graph, x, labels, idx, n_classes,
                                        checkpoint_dir=ck, save_every=half,
                                        **kw))
    fit_s.append(time.perf_counter() - t0 - sum(fit_s))
    resume = {"losses_equal": resumed["report"]["loss_history"]
              == full["report"]["loss_history"],
              "w_equal": bool(np.array_equal(resumed["w"], full["w"])),
              "b_equal": bool(np.array_equal(resumed["b"], full["b"])),
              "losses": full["report"]["loss_history"]}
    if not (resume["losses_equal"] and resume["w_equal"]
            and resume["b_equal"]):
        raise AssertionError(f"resumed fit differs: {resume}")
    _part(out, "fit_adam", t0, resume=resume, fits_s=fit_s,
          train_accuracy=full["report"]["train_accuracy"],
          formulation=full["report"]["formulation"],
          dense_fraction=full["report"]["dense_fraction"])

    t0 = time.perf_counter()
    zero_counts()
    params, report = fit_sharded(graph, x, labels, idx, n_classes,
                                 trainer="newton", **kw)
    # the single-device fit on the same propagated rows, on rank 0
    xs = shard_features(mesh, _padded(x, plan, mesh))
    y_prop = fetch_global(mesh, propagate_sharded(
        mesh, plan.pgraph, xs, cfg["degree"], halo=plan.halo,
        blockdense=plan.blockdense, sync_each_hop=True))
    newton = {"train_accuracy": report.train_accuracy}
    if mesh.rank == 0:
        from sgc_tpu_torch.models.sgc import SGC

        feats = torch.as_tensor(y_prop[idx], device=mesh.device)
        lab = torch.as_tensor(labels[idx], device=mesh.device)
        gen = torch.Generator().manual_seed(cfg["seed"])
        bound = 1.0 / float(np.sqrt(feats.shape[1]))
        w0 = torch.empty((feats.shape[1], n_classes)).uniform_(
            -bound, bound, generator=gen)
        b0 = torch.empty((n_classes,)).uniform_(-bound, bound,
                                                generator=gen)
        single, _ = _newton_linear_fit(
            SGC(w0.to(mesh.device), b0.to(mesh.device)), feats, lab,
            cfg["weight_decay"], None, 8, False, False)
        newton["single_device_train_accuracy"] = float(
            (single(feats).argmax(dim=1) == lab).float().mean())
        if abs(newton["single_device_train_accuracy"]
               - report.train_accuracy) > 0.02:
            raise AssertionError(f"sharded Newton vs single device: {newton}")
    del y_prop
    _part(out, "fit_newton", t0, **newton)

    t0 = time.perf_counter()
    zero_counts()
    tracemalloc.start()
    tile = stage_rows(mesh, mmap_rows(root / "x.npy"),
                      n_rows_padded=plan.pgraph.n_rows_padded)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    same_rows = bool(torch.equal(*(propagate_sharded(
        mesh, plan.pgraph, t, cfg["degree"], halo=plan.halo,
        blockdense=plan.blockdense, sync_each_hop=True) for t in (tile, xs))))
    staged = _fit_summary(*fit_sharded(graph, mmap_rows(root / "x.npy"),
                                       labels, idx, n_classes, **kw))
    same_fit = bool(np.array_equal(staged["w"], full["w"])
                    and np.array_equal(staged["b"], full["b"]))
    if not (same_rows and same_fit):
        raise AssertionError(f"staged form differs: rows {same_rows}, fit "
                             f"{same_fit}")
    _part(out, "staged", t0, peak_host_bytes=int(peak),
          tile_bytes=int(tile.numel() * 4), same_rows=same_rows,
          same_fit=same_fit)


def _padded(x, plan, mesh):
    """x padded as ``fit_sharded`` pads an ndarray."""
    from sgc_tpu_torch.parallel.partition import pad_feature_dim

    return pad_node_rows(pad_feature_dim(np.asarray(x, np.float32),
                                         8 * mesh.shape[FEAT_AXIS]),
                         plan.pgraph.n_rows_padded)


def _training_gcn(root: Path, cfg: dict, mesh, out: dict) -> None:
    """The smoke's sharded GCN part on this rank (see
    :func:`smoke_training_world`)."""
    from sgc_tpu_torch.parallel.gcn import (
        PARAMS,
        ShardedGCNState,
        fit_gcn_sharded,
        make_sharded_gcn_step,
    )
    from sgc_tpu_torch.models.gcn import params_from_jax
    from sgc_tpu_torch.parallel.train import place_node_targets

    import types

    graph, x, labels, idx = _cli_inputs(root)
    n_classes = int(labels.max()) + 1
    pg, ho, _, bd = load_plans(root, 4)
    g = cfg["gcn"]
    t0 = time.perf_counter()
    zero_counts()
    _, losses = fit_gcn_sharded(graph, x, labels, idx, n_classes, mesh=mesh,
                                n_hidden=g["hidden"], epochs=g["epochs"],
                                lr=g["lr"], weight_decay=g["weight_decay"],
                                init_params=g["init"], pgraph=pg, halo=ho)
    _part(out, "gcn_halo", t0, losses=losses)

    t0 = time.perf_counter()
    xs = shard_features(mesh, pad_node_rows(np.asarray(x, np.float32),
                                            pg.n_rows_padded))
    y, m = place_node_targets(mesh, pg.n_rows_padded, labels, idx)
    state = ShardedGCNState(
        params_from_jax(types.SimpleNamespace(**g["init"]),
                        device=mesh.device), {k: {} for k in PARAMS})
    plan = {"blockdense": bd, "precision": g["precision"]}
    held = held_gcn_step(mesh, pg, plan, state, xs, y, m)
    held.pop("grads")
    for direction in ("forward", "backward"):
        for name, (_, rel) in held[direction].items():
            if not rel <= cfg["tolerance"]:
                raise AssertionError(f"GCN {direction} {name} vs plain: "
                                     f"rel err {rel:.3e}")
        if sorted(held[direction]) != ["blockdense_cells", "csr_spmm"]:
            raise AssertionError(f"GCN {direction} held only "
                                 f"{sorted(held[direction])}")
    step = make_sharded_gcn_step(mesh, pg, lr=g["lr"],
                                 weight_decay=g["weight_decay"], **plan)
    zero_counts()
    steps = []
    for _ in range(g["bd_steps"]):
        state, loss = step(state, xs, y, m)
        steps.append(float(loss))
    if not all(np.isfinite(steps)):
        raise AssertionError(f"block-dense GCN losses {steps}")
    _part(out, "gcn_blockdense", t0, losses=steps, held=held)
    out["backward_kernels"] = _backward_kernel_times(
        mesh, pg, bd, n_classes, cfg["reps"])


def _training_inductive(root: Path, cfg: dict, mesh, out: dict) -> None:
    """The smoke's dual propagation part on this rank (see
    :func:`smoke_training_world`)."""
    from sgc_tpu_torch.parallel.inductive import (
        DualPartition,
        inductive_dual_propagate,
        train_exchange_plan,
    )

    x = np.load(root / "x.npy", mmap_mode="r")
    idx = np.load(root / "idx_train.npy")
    pf, _, hf, bdf = load_plans(root, 4)
    pt, ht = (load_host(root / "train4" / n) for n in ("pgraph", "halo"))
    bdt = load_host(root / "train4" / "bd")
    send, recv = train_exchange_plan(idx, pf.rows_per_part, pt.rows_per_part,
                                     4)
    for form, (fb, tb), tol in (("segment", (None, None), cfg["tolerance"]),
                                ("blockdense", (bdf, bdt),
                                 cfg["bf16_tolerance"])):
        t0 = time.perf_counter()
        zero_counts()
        dual = DualPartition(full=pf, train=pt, full_halo=hf, train_halo=ht,
                             idx_train=idx, full_bd=fb, train_bd=tb,
                             train_send=send, train_recv=recv)
        ev, tr = inductive_dual_propagate(mesh, dual, x, cfg["degree"])
        sync(mesh.device)
        hops_s = time.perf_counter() - t0
        launches = read_counts(COUNTERS)
        errs = {}
        for name, tile, n, ref in (
                ("eval", ev, pf.n_rows, f"ref_{form}.npy"),
                ("train", tr, pt.n_rows, f"ref_train_{form}.npy")):
            full = fetch_global(mesh, tile)
            if mesh.rank == 0:
                errs[name] = _against(full, root / ref, n, tol, mesh.device)
        out["parts"][f"inductive_{form}"] = {
            "seconds": time.perf_counter() - t0, "hops_s": hops_s,
            "launches": launches, "vs_single_device": errs}


def smoke_training_world(root: str, cfg: dict) -> dict:
    """The chip smoke's ``sharded_training_path`` on 4 ranks (gloo, every
    rank on the card), once ``root/ready_training`` exists:

    * ``fit_sharded`` on (2, 2) with the parent's plan ``fit22/``: Adam
      epochs, a checkpointed half resumed bit for bit against the
      uninterrupted fit; the Newton trainer against the single-device
      Newton fit on the same propagated rows (train accuracy within 2
      points); the staged form from ``mmap_rows`` over ``x.npy`` (its
      propagated rows and its fit bit for bit the ndarray form's, and the
      staging's peak host bytes);
    * ``fit_gcn_sharded`` on (4, 1) through the P = 4 halo plan from
      ``cfg["gcn"]["init"]``; one step through the block-dense plan with
      every kernel A and B launch, forward and backward, held against its
      plain version; more steps; the backward's kernels timed alone;
    * ``inductive_dual_propagate`` on the full and train graphs, segment
      and block-dense, gathered against single-device kernel-B hops.

    Each part zeroes the launch counters just before it and reads them
    just after. Every rank returns its parts; rank 0 adds the
    comparisons."""
    t_start, started_unix = time.perf_counter(), time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(root)
    while not (root / "ready_training").exists():
        if (root / "abort").exists():
            raise RuntimeError("the parent stopped before the plans were "
                               "ready")
        time.sleep(0.05)
    marks = [("wait_s", time.perf_counter())]
    out = {"parts": {}, "started_unix": started_unix}
    dev = cfg.get("device")
    meshes = {s: make_mesh(*s, device=dev) for s in ((2, 2), (4, 1))}
    marks.append(("meshes_s", time.perf_counter()))
    _training_fits(root, cfg, meshes[(2, 2)], out)
    marks.append(("fits_s", time.perf_counter()))
    _training_gcn(root, cfg, meshes[(4, 1)], out)
    marks.append(("gcn_s", time.perf_counter()))
    _training_inductive(root, cfg, meshes[(4, 1)], out)
    marks.append(("inductive_s", time.perf_counter()))
    prev, out["sections_s"] = t_start, {}
    for name, t in marks:
        out["sections_s"][name], prev = t - prev, t
    return out


def smoke_training_world_of_one(root: str, cfg: dict) -> dict:
    """The chip smoke's NCCL world of one rank: ``fit_sharded`` (segment,
    P = 1) on a (1, 1) NCCL mesh and on a (1, 1) gloo mesh of the same
    process, bit for bit."""
    from sgc_tpu_torch.parallel.fit import fit_sharded, plan_fit

    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(root)
    graph, x, labels, idx = _cli_inputs(root)
    plan = plan_fit(graph, 1, 1, x.shape[1], formulation="segment")
    runs = []
    for transport in cfg.get("transports", ("nccl", "gloo")):
        mesh = make_mesh(1, 1, device=cfg.get("device"),
                         transport=transport)
        t0 = time.perf_counter()
        zero_counts()
        run = _fit_summary(*fit_sharded(
            graph, x, labels, idx, int(labels.max()) + 1, mesh=mesh,
            degree=cfg["degree"], epochs=cfg["one_epochs"], lr=cfg["lr"],
            weight_decay=cfg["weight_decay"], seed=cfg["seed"], plan=plan))
        run["seconds"] = time.perf_counter() - t0
        run["launches"] = read_counts(COUNTERS)
        runs.append(run)
    n, g = runs
    same = bool(np.array_equal(n["w"], g["w"]) and np.array_equal(
        n["b"], g["b"]) and n["report"]["loss_history"]
        == g["report"]["loss_history"])
    if not same:
        raise AssertionError("fit_sharded in NCCL and gloo worlds of one "
                             "differ")
    return {"same_bits": same, **{t: {"seconds": r["seconds"],
                                      "launches": r["launches"],
                                      "losses": r["report"]["loss_history"]}
                                  for t, r in zip(("nccl", "gloo"), runs)}}
