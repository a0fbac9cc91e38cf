"""Host <-> mesh data movement and the port's own rank launcher (the
counterpart of sgc_tpu/parallel/distributed.py).

* :func:`put_global` cuts a rank's tile out of a full host value that
  every rank holds (the reference's SPMD contract: each process passes
  the same full value and keeps its own shards).
* :func:`fetch_global` gathers the full array to host numpy on every
  rank of the mesh: a collective, called by all of them in the same
  order.
* :func:`save_host` / :func:`load_host` move host plans to ranks as
  one ``.npy`` file per array (memory-mapped on load, so a rank reads
  only its own part), never through the spawn pipe.
* :func:`launch` starts ``world_size`` ranks with the ``spawn`` start
  method (a parent that holds a CUDA context cannot ``fork``), each
  joining one process group that rendezvouses through a ``file://``
  store in a directory the caller passes (no TCP port is involved), runs
  ``fn(*args)`` on every rank and returns each rank's result. On any
  rank's failure, or at the deadline, it kills every rank and raises.

A rank unpickles ``fn`` by its module name, so ``fn`` must be a
module-level function of ``sgc_tpu_torch`` (``parallel/bodies.py``
holds the ones the tests and the chip smoke run): a rank imports the
port and nothing else.

The reference's ``scrub_single_host_tpu_env`` is not ported: it removes
TPU-runtime variables that only confuse ``jax.distributed`` on a TPU
host, and nothing of the kind exists for ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pickle
import time
import traceback
import uuid
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sgc_tpu_torch.graph.sparse import host
from sgc_tpu_torch.parallel.mesh import FEAT_AXIS, NODES_AXIS, Mesh

# the sharding of node features: rows over "nodes", columns over "feat"
NODE_FEAT = (NODES_AXIS, FEAT_AXIS)


def _tile_slices(mesh: Mesh, spec: tuple, shape: tuple) -> tuple:
    out = []
    for d, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
            continue
        n = mesh.shape[axis]
        if shape[d] % n:
            raise ValueError(f"dim {d} of size {shape[d]} does not divide "
                             f"over {n} {axis!r} shards")
        w = shape[d] // n
        out.append(slice(mesh.coords[axis] * w, (mesh.coords[axis] + 1) * w))
    return tuple(out)


def put_global(mesh: Mesh, spec: tuple, value) -> torch.Tensor:
    """This rank's tile of the full ``value`` under ``spec`` (one axis
    name or None per leading dim, the reference's PartitionSpec), as a
    contiguous tensor on the mesh's device. ``value`` is numpy (e.g. a
    memory map: only the tile is read) or a tensor."""
    tile = value[_tile_slices(mesh, tuple(spec), tuple(value.shape))]
    if not torch.is_tensor(tile):
        tile = torch.from_numpy(np.ascontiguousarray(tile))
    return tile.to(mesh.device).contiguous()


def fetch_global(mesh: Mesh, tile: torch.Tensor,
                 spec: tuple = NODE_FEAT) -> np.ndarray:
    """The full host value of a sharded array from every rank's ``tile``
    (a collective over the mesh: the "feat" tiles are joined first, then
    the "nodes" rows). Over gloo the tiles are gathered on the host and
    the result never visits the device."""
    full = tile.cpu() if mesh.transport == "gloo" else tile
    for axis in (FEAT_AXIS, NODES_AXIS):
        if axis in spec:
            full = mesh.all_gather(axis, full, dim=tuple(spec).index(axis))
    return host(full)


def save_host(path, obj) -> None:
    """Write a host dataclass of the port (a SparseGraph or a plan: numpy
    arrays, tuples of them, scalars) under directory ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            np.save(path / f"{f.name}.npy", v)
            fields[f.name] = "array"
        elif isinstance(v, tuple):
            for i, a in enumerate(v):
                np.save(path / f"{f.name}.{i}.npy", np.asarray(a))
            fields[f.name] = len(v)
        elif v is None or isinstance(v, (bool, int, float, np.number)):
            fields[f.name] = {"value": v.item() if isinstance(
                v, np.number) else v}
        else:
            raise TypeError(f"{type(obj).__name__}.{f.name}: cannot save "
                            f"{type(v).__name__}")
    cls = type(obj)
    if not cls.__module__.startswith("sgc_tpu_torch."):
        raise TypeError(f"{cls.__qualname__} is not a class of the port")
    (path / "meta.json").write_text(json.dumps(
        {"class": [cls.__module__, cls.__qualname__], "fields": fields}))


def load_host(path, mmap: bool = True):
    """The object :func:`save_host` wrote; arrays memory-mapped unless
    ``mmap=False``."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    module, name = meta["class"]
    if not module.startswith("sgc_tpu_torch."):
        raise ValueError(f"{path}: not a class of the port")
    cls = getattr(importlib.import_module(module), name)
    mode = "r" if mmap else None
    kw = {}
    for field, how in meta["fields"].items():
        if how == "array":
            kw[field] = np.load(path / f"{field}.npy", mmap_mode=mode)
        elif isinstance(how, int):
            kw[field] = tuple(np.load(path / f"{field}.{i}.npy",
                                      mmap_mode=mode) for i in range(how))
        else:
            kw[field] = how["value"]
    return cls(**kw)


def _rank_main(fn, rank: int, world_size: int, backend: str, store: str,
               timeout_s: float, result: str, args: tuple) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, write
    ``("ok", value)`` or ``("error", traceback)`` to ``result``."""
    os.environ["LOCAL_RANK"] = str(rank)
    # the ranks share the host's cores: one intra-op pool each, not
    # world_size pools of every core
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    status = 0
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world_size, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        out = ("ok", fn(*args))
    except BaseException:  # reported to the parent, then re-raised
        out = ("error", traceback.format_exc())
        status = 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(result, "wb") as f:
        pickle.dump(out, f)
    if status:
        raise SystemExit(status)


def launch(fn, world_size: int, backend: str, init_dir, args: tuple = (),
           timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks that share one
    ``backend`` process group (``"gloo"`` or ``"nccl"``); returns the
    ranks' results in rank order.

    ``init_dir`` holds the ``file://`` store and the results (a fresh
    store per call). Each rank sets ``LOCAL_RANK``, takes its share of
    the host's cores for its intra-op threads and, with a card, its
    device ``cuda:(rank % device_count)``. Raises RuntimeError with
    the rank's traceback when a rank fails, and TimeoutError after
    ``timeout_s`` seconds (also each rank's collective timeout); either
    way every rank is killed first.
    """
    init_dir = Path(init_dir)
    init_dir.mkdir(parents=True, exist_ok=True)
    tag = uuid.uuid4().hex
    store = init_dir / f"store_{tag}"
    results = [init_dir / f"result_{tag}_{r}.pkl" for r in range(world_size)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, str(store),
                               timeout_s, str(results[r]), tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{fn.__name__} on {world_size} ranks ({backend}) did "
                    f"not finish in {timeout_s:.0f} s")
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        store.unlink(missing_ok=True)
    out = []
    for r, path in enumerate(results):
        if not path.exists():
            if r == failed:
                raise RuntimeError(f"rank {r} of {fn.__name__} died (exit "
                                   f"{procs[r].exitcode}) with no report")
            out.append(None)
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        path.unlink()
        if status == "error" and (failed is None or r == failed):
            raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{value}")
        out.append(value)
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {fn.__name__} failed (exit "
                           f"{procs[failed].exitcode})")
    return out
