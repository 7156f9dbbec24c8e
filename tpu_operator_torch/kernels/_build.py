"""Build a kernel source under ``csrc/`` with ``nvcc`` into a shared library
with a plain C interface, load it with ``ctypes``, and launch its entries.

Nothing builds at import: the first call to ``library(name)`` compiles
``csrc/<name>.cu`` for ``sm_90a`` into ``tpu_operator_torch/_build/`` (listed
in ``.gitignore``), under a file name keyed by a hash of the source, the
headers under ``csrc/`` (``*.cuh``, which a source includes) and the flags,
so an edited source or header never loads a stale library and a fresh
checkout builds what it needs.  The library is loaded once per process.

``ENTRIES`` declares every C entry the wrappers call, with its ctypes
argument types; ``launch`` is the one way a wrapper runs one, and
``launches`` reads how many times each ran in this process.
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

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# q, k, v, <state pointers>, bh, tq, tk, d, q_off, k_off, causal, scale, stream
_FORWARD = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I64, _I64, _I, _F, _P)
_UPDATE = (_P, *_FORWARD)  # the state m, l, o in place of out, lse
# q, k, v, dout, lse, dsum, dq, dk, dv, bh, tq, tk, d, q_off, k_off, causal, scale, stream
_BACKWARD = (*[_P] * 9, *_FORWARD[5:13], _P)

# Every ``extern "C"`` entry of ``csrc/<library>.cu`` that the wrappers call,
# by library: its ctypes argument types.  Each returns an int; an entry that
# launches takes the stream last and returns a cudaError_t (0 on success).
ENTRIES = {
    "vector_add": {"tpu_vector_add": (_P, _P, _P, _I64, _I, _P)},
    "dma_pipeline": {"tpu_dma_pipeline_copy": (_P, _P, _I64, _I, _I, _I, _I, _P)},
    "flash_attention": {
        "tpu_flash_forward_bf16": _FORWARD,
        # the forward's, plus the f32 scratch after lse and n_splits before the stream
        "tpu_flash_forward_split_bf16": (*_FORWARD[:5], _P, *_FORWARD[5:13], _I, _P),
        "tpu_flash_block_update_bf16": _UPDATE,
        "tpu_flash_block_backward_bf16": _BACKWARD,
    },
    "flash_forward_sm90": {"tpu_flash_forward_wgmma_bf16": _FORWARD},
    "flash_forward_f32": {
        "tpu_flash_forward_f32": _FORWARD,
        # q, k_pool, v_pool, block_tables, lengths, out, lse, part, requests, heads, d,
        # block_tokens, width, max_splits, split_pages, scale, stream
        "tpu_flash_paged_f32": (*[_P] * 8, *[_I] * 7, _F, _P),
    },
    # the bf16 entries', with the sliding window after ``causal``
    "flash_backward": {
        "tpu_flash_block_update_f32": (*_UPDATE[:13], _I, *_UPDATE[13:]),
        "tpu_flash_block_backward_f32": (*_BACKWARD[:16], _I, *_BACKWARD[16:]),
        # kernel (0 dk/dv, 1 dq, 2 the fold), d: a block's dynamic shared memory
        "tpu_flash_train_smem_bytes": (_I, _I),
    },
}
_LIBRARY = {entry: lib for lib, entries in ENTRIES.items() for entry in entries}

_bound: dict = {}
_launches = dict.fromkeys(_LIBRARY, 0)


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


def bind(entry: str):
    """The C function ``entry`` of ``ENTRIES``, its argument types set, its
    library built and loaded on first use."""
    if entry not in _bound:
        fn = getattr(library(_LIBRARY[entry])[0], entry)
        fn.argtypes = ENTRIES[_LIBRARY[entry]][entry]
        fn.restype = ctypes.c_int
        _bound[entry] = fn
    return _bound[entry]


def launch(entry: str, device, *args) -> None:
    """Run the launching C ``entry`` with ``args`` on ``device``'s current
    stream, which it takes last (no synchronize), and count the launch.
    Raises ``RuntimeError`` naming the library, the entry and the error
    when the entry returns one."""
    import torch

    fn = bind(entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_LIBRARY[entry]}: {entry} failed: cudaError {rc}")
    _launches[entry] += 1


def launches() -> dict:
    """Launches of each C entry in this process, by entry name, from 0: a
    run shows that it went through a kernel by reading this before and
    after."""
    return dict(_launches)
