"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for
``sm_90a`` into ``build/sgc_tpu_torch/lib<name>.so`` with a plain C
interface, and loaded with ctypes (no PyTorch headers, so a build takes
seconds). Builds happen at first use and again when a source is newer
than its library; :func:`build_all` starts every due build at once.

Nothing here runs at import time: this module imports on a machine with
no ``nvcc`` and no card, as the CPU tests do.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sgc_tpu_torch import native
from sgc_tpu_torch.utils.buildlib import (
    BUILD_DIR,
    LibSpec,
    ensure_built,
    nvcc_path,
)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# the package's paths launch these: load_all builds and loads them
KERNEL_SOURCES = ("blockdense", "spmm_csr", "sddmm")
# only the sgc_tpu_torch.scripts probes launch these: each is built at
# its first use, so no package path waits on (or fails with) their build
PROBE_SOURCES = ("probe_copy", "row_gather", "edge_accumulate",
                 "blockdense_int8")

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signature of each library's entry points: {symbol: argtypes}; the
# first symbol is the library's default entry
_ENTRY = {
    "blockdense": {"blockdense_cells":
                   [_V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _V]},
    "spmm_csr": {"csr_spmm": [_V] * 6 + [_I] * 9 + [_V] * 3},
    "sddmm": {"sddmm": [_V] * 5 + [_L, _L] + [_I] * 11 + [_V]},
    "probe_copy": {"probe_scale2": [_V, _V, _L, _V],
                   "probe_select_blocks": [_V, _V, _V, _I, _I, _L, _V],
                   "probe_launch_floor": [_I, _V]},
    "row_gather": {"row_gather_load": [_V, _V, _V, _L] + [_I] * 6 + [_V],
                   "row_gather_async": [_V, _V, _V, _L] + [_I] * 7 + [_V]},
    "edge_accumulate": {"edge_accumulate":
                        [_V] * 5 + [_L] + [_I] * 5 + [_V] * 9,
                        "edge_buckets": [_V] * 3 + [_L] + [_I] * 4
                        + [_V] * 9,
                        "edge_accumulate_bucketed": [_V] * 7 + [_L]
                        + [_I] * 4 + [_V],
                        "edge_chain_cycles": [_V, _V, _I, _V]},
    "blockdense_int8": {"blockdense_int8_cells":
                        [_V] * 7 + [_I] * 6 + [_V]},
}

_loaded: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def kernel_spec(name: str) -> LibSpec:
    src = CSRC / f"{name}.cu"
    return LibSpec(
        source=src,
        output=BUILD_DIR / f"lib{name}.so",
        command=(nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", str(src)),
    )


def build_all(names=KERNEL_SOURCES + PROBE_SOURCES) -> dict[str, float]:
    """Build the stale kernel libraries of ``names`` (default: all) and
    the host library together (one compiler process each). Returns build
    seconds per library."""
    return ensure_built([kernel_spec(n) for n in names]
                        + [native.LIB_SPEC])


def load_all(device) -> None:
    """On a CUDA ``device``, build every stale library of the package's
    paths at once and load each entry, so that no build or load falls
    inside a timed span; on any other device nothing launches a kernel,
    so nothing to do. Once every entry is loaded a call returns at once:
    :func:`entry` keeps the functions it loaded, so a library rebuilt
    later would not be loaded again anyway, and the staleness checks (a
    few file-system calls a library, 2.4 ms a call on the H100's host)
    stay out of callers that run every step, as ``sgc_precompute``."""
    if torch.device(device).type != "cuda":
        return
    if all((name, symbol) in _loaded for name in KERNEL_SOURCES
           for symbol in _ENTRY[name]):
        return
    build_all(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        for symbol in _ENTRY[name]:
            entry(name, symbol)


def entry(name: str, symbol: str | None = None):
    """The C entry point ``symbol`` (default: the library's first) of
    kernel library ``name``, built if needed."""
    symbol = symbol or next(iter(_ENTRY[name]))
    fn = _loaded.get((name, symbol))
    if fn is None:
        spec = kernel_spec(name)
        ensure_built([spec])
        fn = getattr(ctypes.CDLL(str(spec.output)), symbol)
        fn.argtypes = _ENTRY[name][symbol]
        fn.restype = ctypes.c_int
        _loaded[(name, symbol)] = fn
    return fn


# PyTorch's getter of the current stream's raw handle, the one its own
# generated code calls: an int, with no Stream object built (building one,
# torch.cuda.current_stream, cost ~3.6 us a call on the H100's host). A
# CPU-only build has none; stream_of then raises.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device (so
    a launch follows ``with torch.cuda.stream(s):``)."""
    if _RAW_STREAM is None:
        raise RuntimeError("this PyTorch has no torch._C."
                           "_cuda_getCurrentRawStream: no CUDA build")
    return _RAW_STREAM(t.get_device())


def check_launch(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require_cuda_f32(t: torch.Tensor, what: str, shape=None) -> None:
    """Validate a kernel operand: contiguous float32 on a CUDA device. The
    messages are built only when a check fails."""
    if not (t.is_cuda and t.dtype is torch.float32):
        raise ValueError(f"{what} must be a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
