"""Build a kernel source under ``csrc/`` with ``nvcc`` into a shared library
with a plain C interface, and load it with ``ctypes``.

Nothing builds at import: the first call to ``library(name)`` compiles
``csrc/<name>.cu`` for ``sm_90a`` into ``tpu_operator_torch/_build/`` (listed
in ``.gitignore``), under a file name keyed by a hash of the source, the
headers under ``csrc/`` (``*.cuh``, which a source includes) and the flags,
so an edited source or header never loads a stale library and a fresh
checkout builds what it needs.  The library is loaded once per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)


@dataclass(frozen=True)
class Built:
    path: str
    seconds: float  # 0.0 when the library was already on disk
    log: str        # nvcc's output (ptxas resource usage), empty when cached


_loaded: dict[str, tuple[ctypes.CDLL, Built]] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME", "")
    for candidate in (
        os.path.join(home, "bin", "nvcc") if home else "",
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH")


def target(name: str) -> tuple[str, str]:
    """``(digest, path)`` of ``csrc/<name>.cu``'s library, without building
    it: the digest hashes the source, every header under ``csrc/`` (in name
    order) and ``NVCC_FLAGS`` (the arch among them), the path is where
    ``build`` puts the library."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        source = f.read()
    for header in sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, header), "rb") as f:
            source += f.read()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return digest, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source and
    flag set is already built; returns where it is and what it cost."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    _, out = target(name)
    if os.path.exists(out):
        return Built(out, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process tmp + replace: concurrent first users never load a
    # half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return Built(out, seconds, log)


def library(name: str) -> tuple[ctypes.CDLL, Built]:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        built = build(name)
        _loaded[name] = (ctypes.CDLL(built.path), built)
    return _loaded[name]
