"""Build the port's shared libraries from the sources in the checkout.

Two kinds of library, both loaded with ctypes through a plain C ABI:

* the host graph-prep library (``native/graphprep.cpp``, ``g++``);
* one library per CUDA source in ``csrc/`` (``nvcc`` for ``sm_90a``).

Every library lands in ``build/sgc_tpu_torch/`` at the repository root
(git-ignored), never inside the package. A library is rebuilt when its
source is newer than it. Builds that are due start together, one compiler
process per source, and each writes to a private temporary file that is
renamed into place, so concurrent processes (test workers) never load a
half-written library. Each compiler's output is kept beside the library
as ``<name>.log`` (for ``nvcc`` it holds ``-Xptxas -v``'s register and
shared-memory report).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "sgc_tpu_torch"


@dataclass(frozen=True)
class LibSpec:
    """One shared library: its source, its output and the compiler
    command without the ``-o`` argument."""

    source: Path
    output: Path
    command: tuple[str, ...]

    def stale(self) -> bool:
        if not self.output.exists():
            return True
        return self.source.stat().st_mtime > self.output.stat().st_mtime


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location. Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def ensure_built(specs: list[LibSpec]) -> dict[str, float]:
    """Build every stale library in ``specs`` concurrently.

    Returns ``{library file name: build seconds}`` for the libraries that
    were built (an up-to-date library is absent). Raises RuntimeError
    with the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for spec in specs:
        if not spec.stale():
            continue
        tmp = spec.output.with_name(f"{spec.output.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [*spec.command, "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((spec, tmp, proc, time.perf_counter()))
    seconds = {}
    errors = []
    for spec, tmp, proc, t0 in running:
        out, _ = proc.communicate()
        seconds[spec.output.name] = time.perf_counter() - t0
        spec.output.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"building {spec.source.name} failed "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, spec.output)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds
