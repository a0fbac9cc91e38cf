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
KERNEL_SOURCES = ("blockdense", "spmm_csr", "sddmm")

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signature of each library's entry point: (symbol, argtypes)
_ENTRY = {
    "blockdense": ("blockdense_cells",
                   [_V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _V]),
    "spmm_csr": ("csr_spmm", [_V, _V, _V, _V, _V, _V, _I, _I, _I, _V]),
    "sddmm": ("sddmm", [_V, _V, _V, _V, _V, _L, _L, _I, _I, _I, _V]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def kernel_spec(name: str) -> LibSpec:
    src = CSRC / f"{name}.cu"
    return LibSpec(
        source=src,
        output=BUILD_DIR / f"lib{name}.so",
        command=(nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", str(src)),
    )


def build_all() -> dict[str, float]:
    """Build every stale kernel library and the host library together
    (one compiler process each). Returns build seconds per library."""
    return ensure_built([kernel_spec(n) for n in KERNEL_SOURCES]
                        + [native.LIB_SPEC])


def load_all(device) -> None:
    """On a CUDA ``device``, build every stale library at once and load
    every kernel's entry, so that no build or load falls inside a timed
    span; on any other device nothing launches a kernel, so nothing to
    do."""
    if torch.device(device).type != "cuda":
        return
    build_all()
    for name in KERNEL_SOURCES:
        entry(name)


def entry(name: str):
    """The C entry point of kernel library ``name``, built if needed."""
    fn = _loaded.get(name)
    if fn is None:
        spec = kernel_spec(name)
        ensure_built([spec])
        symbol, argtypes = _ENTRY[name]
        fn = getattr(ctypes.CDLL(str(spec.output)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require_cuda_f32(t: torch.Tensor, what: str, shape=None) -> None:
    """Validate a kernel operand: contiguous float32 on a CUDA device."""
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{what} must be a float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
