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

from sgc_tpu_torch.ops import autograd
from sgc_tpu_torch.ops import spmm as spmm_ops
from sgc_tpu_torch.ops import spmm_blockdense as bd_ops
from sgc_tpu_torch.ops import spmm_tiled
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
from sgc_tpu_torch.utils.profiling import sync

# every kernel's launch counter, by its name in the chip smoke's kernels
# line (the sharded path launches A and B only; the rest read 0)
COUNTERS = {"blockdense_cells": (bd_ops, "LAUNCHES"),
            "csr_spmm": (spmm_ops, "LAUNCHES"),
            "tiled_spmm": (spmm_tiled, "LAUNCHES"),
            "sddmm": (spmm_ops, "SDDMM_LAUNCHES"),
            "csr_spmm_transposed": (autograd, "TRANSPOSED_LAUNCHES")}


def zero_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in COUNTERS.items()}


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
    launches = read_counts()
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
        launches = read_counts()
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
