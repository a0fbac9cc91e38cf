"""Probe: per-edge gather-accumulate in a hand-written kernel, in edge
order (the counterpart of scripts/exp_gather_probe.py).

For each edge ``(r, c, v)`` of ``chunks * chunk`` edges, in order, kernel
G (``csrc/edge_accumulate.cu``) updates a row of the ``rows x f`` output
with a scaled row of the ``wcols x f`` table; ``--mode`` picks the update
as in the reference (rmw ``out[r] += v x[c]``, store ``out[r] = v x[c]``,
fixed_out row 0, fixed_in x row 0, noop both). Prints, as the reference:

  P1  seconds to the first result (build included when not built)
  P2  max error against the scatter-add oracle (the reference's
      ``np.add.at``, computed as the host's sequential ``index_add_``,
      the same bits), relative to its max: 0 for rmw, not for the other
      modes, which compute other functions
  P3  ms over ``--repeats`` calls, ns/edge and M edges/s

Inputs as the reference makes them (``RandomState(0)``: rows, cols, vals,
then x).

    python -m sgc_tpu_torch.scripts.exp_gather_probe [--rows 2048]
        [--wcols 2048] [--f 768] [--chunk 1024] [--chunks 64]
        [--repeats 5] [--mode rmw] [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from sgc_tpu_torch.ops import edge_accumulate as ea
from sgc_tpu_torch.scripts import backend, device_parser
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync


def make_inputs(rows: int, wcols: int, f: int, chunk: int,
                chunks: int) -> tuple[np.ndarray, ...]:
    """The reference's ``(rows, cols, vals, x)``."""
    rng = np.random.RandomState(0)
    n = chunks * chunk
    r = rng.randint(0, rows, size=(n,)).astype(np.int32)
    c = rng.randint(0, wcols, size=(n,)).astype(np.int32)
    v = rng.rand(n).astype(np.float32)
    x = rng.rand(wcols, f).astype(np.float32)
    return r, c, v, x


def oracle(rows, cols, vals, x, n_rows: int) -> torch.Tensor:
    """The reference's P2 oracle, ``np.add.at(zeros, rows, vals[:, None]
    * x[cols])``, on the host: a sequential scatter-add in edge order."""
    rows, cols, vals, x = (t.cpu() for t in (rows, cols, vals, x))
    return torch.zeros((n_rows, x.shape[1])).index_add_(
        0, rows.long(), vals.unsqueeze(1) * x[cols.long()])


def run(rows, cols, vals, x, n_rows: int, mode: str = "rmw",
        repeats: int = 5) -> dict:
    """P1, P2 and P3 of one mode; returns their numbers and the output."""
    dev = x.device
    print("backend:", backend(dev), flush=True)
    t0 = time.perf_counter()
    y = ea.edge_accumulate(rows, cols, vals, x, n_rows, mode)
    sync(dev)
    p1 = time.perf_counter() - t0
    print(f"P1 compiled+ran in {p1:.1f}s", flush=True)
    expect = oracle(rows, cols, vals, x, n_rows)
    err = float((y.cpu() - expect).abs().max()) / max(
        1e-9, float(expect.abs().max()))
    print(f"P2 rel_err={err:.2e}", flush=True)
    t0 = time.perf_counter()
    for _ in range(repeats):
        y = ea.edge_accumulate(rows, cols, vals, x, n_rows, mode)
    sync(dev)
    dt = (time.perf_counter() - t0) / repeats
    e = int(rows.shape[0])
    print(f"P3 {dt * 1e3:.2f} ms for {e} edges -> {dt / e * 1e9:.1f} "
          f"ns/edge ({e / dt / 1e6:.1f}M edges/s)", flush=True)
    return {"p1_s": p1, "rel_err_vs_oracle": err, "ms": dt * 1e3,
            "ns_per_edge": dt / e * 1e9, "m_edges_per_s": e / dt / 1e6,
            "out": y}


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--rows", type=int, default=2048, help="out block rows")
    p.add_argument("--wcols", type=int, default=2048, help="x stripe rows")
    p.add_argument("--f", type=int, default=768)
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--chunks", type=int, default=64)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--mode", default="rmw", choices=ea.MODES,
                   help="which per-edge update: full read-modify-write, "
                        "plain store, fixed out row, fixed in row, or "
                        "both fixed")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    arrays = make_inputs(a.rows, a.wcols, a.f, a.chunk, a.chunks)
    run(*(torch.from_numpy(t).to(dev) for t in arrays), a.rows, a.mode,
        a.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
