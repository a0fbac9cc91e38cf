"""Probe: a row gather ``out = x[idx]`` inside a hand-written kernel, and
at what rate (the counterpart of scripts/exp_take_probe.py).

The reference tried three JAX spellings inside a Pallas kernel (A
``jnp.take``, B ``x[idx, :]``, C ``take_along_axis``); all three are one
function, ``out = x[idx]``, which kernel F (``csrc/row_gather.cu``)
computes through two Hopper entries, each reported on one line with the
reference's fields (max error against the host's ``x[idx]``, ms,
ns/row, M rows/s):

  load   warps copy rows with 16-byte vector loads
  async  rows through shared memory by cp.async, rg.DEFAULT_IN_FLIGHT
         rows in flight a CTA

Inputs as the reference makes them (``RandomState(0)``: ``idx`` of
``chunks * chunk`` rows into a ``wcols x f`` table).

    python -m sgc_tpu_torch.scripts.exp_take_probe [--wcols 2048] [--f 768]
        [--chunk 1024] [--chunks 64] [--repeats 5]
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sgc_tpu_torch.ops import row_gather as rg
from sgc_tpu_torch.scripts import backend, device_parser
from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import timed_runs

# the reference's forms, all the function ``x[idx]``
REFERENCE_FORMS = {"A": "jnp.take(x, idx, axis=0)", "B": "x[idx, :]",
                   "C": "jnp.take_along_axis(x, idx[:, None], axis=0)"}


def make_inputs(wcols: int, f: int, chunk: int,
                chunks: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's ``(x, idx)``: ``RandomState(0)``, idx first."""
    rng = np.random.RandomState(0)
    idx = rng.randint(0, wcols, size=(chunks * chunk,)).astype(np.int32)
    x = rng.rand(wcols, f).astype(np.float32)
    return x, idx


def run(x: torch.Tensor, idx: torch.Tensor, repeats: int = 5,
        in_flight: int = rg.DEFAULT_IN_FLIGHT) -> dict:
    """Each entry of kernel F once against the host's ``x[idx]``, then
    timed over ``repeats`` calls (host clock, each call closed by a
    sync); one line an entry. Returns ``{entry: {err, ms, ...}}``."""
    print("backend:", backend(x.device), flush=True)
    print("reference forms " + ", ".join(
        f"{k} {v}" for k, v in REFERENCE_FORMS.items())
        + ": one function, out = x[idx]; Hopper entries "
        + ", ".join(rg.ENTRIES), flush=True)
    expect = x.cpu()[idx.cpu().long()]
    e = int(idx.shape[0])
    result = {}
    for entry in rg.ENTRIES:
        y = rg.row_gather(x, idx, entry, in_flight)
        err = float((y.cpu() - expect).abs().max())
        ts, _ = timed_runs(lambda: rg.row_gather(x, idx, entry, in_flight),
                           repeats)
        dt = sum(ts) / len(ts)
        print(f"{entry} ok err={err:.1e}  {dt * 1e3:.2f} ms "
              f"-> {dt / e * 1e9:.1f} ns/row ({e / dt / 1e6:.1f}M rows/s)",
              flush=True)
        result[entry] = {"err": err, "ms": dt * 1e3,
                         "ns_per_row": dt / e * 1e9,
                         "m_rows_per_s": e / dt / 1e6}
    return result


def main(argv=None) -> int:
    p = device_parser(__doc__)
    p.add_argument("--wcols", type=int, default=2048)
    p.add_argument("--f", type=int, default=768)
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--chunks", type=int, default=64)
    p.add_argument("--repeats", type=int, default=5)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    x, idx = make_inputs(a.wcols, a.f, a.chunk, a.chunks)
    run(torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev),
        a.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
