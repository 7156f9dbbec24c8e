"""The hbm-dma probe's DMA-pipeline copy kernel (``csrc/dma_pipeline.cu``)
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_pipeline_kernel`` / ``dma_pipeline_copy``
(``tpu_operator/workloads/hbm_pallas.py:48-117``): ``iters`` passes that copy
``x`` into the output through a ``slots``-deep ring of async copies, bit for
bit.  ``chunk_rows`` and ``slots`` keep the reference's contract and its
``ValueError``s.  On the card a chunk of the TPU's size does not fit in a
block's shared memory, so the kernel streams tiles of at most 32 KiB
(``tile_bytes``), each block with its own ``slots``-deep ring.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_operator_torch.kernels import _build

# launches of the CUDA kernel in this process: a run shows it went through
# the kernel by reading this before and after (chip_smoke.py sets it to 0)
launches = 0

MAX_TILE_BYTES = 32 * 1024   # 16 rows of 512 f32: a slot of the shared-memory ring
SMEM_BYTES = 227 * 1024      # shared memory a Hopper block can opt in to
_BARRIER_BYTES = 128         # per 16 slots: the mbarriers, rounded up as the kernel does


def dma_pipeline_copy_reference(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version: ``out.copy_(x)``, ``iters`` times."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    for _ in range(iters):
        out.copy_(x)
    return out


def tile_bytes(x: torch.Tensor, chunk_rows: int, slots: int) -> int:
    """The kernel's tile: at most 32 KiB, at most one chunk, and small
    enough that ``slots`` of them fit in a block's shared memory beside the
    barriers; a multiple of 16 bytes.  Raises when ``slots`` cannot fit."""
    budget = SMEM_BYTES - _BARRIER_BYTES * ((slots + 15) // 16)
    chunk = chunk_rows * x.shape[1] * x.element_size()
    tile = min(MAX_TILE_BYTES, chunk, budget // slots) // 16 * 16
    if tile < 16:
        raise ValueError(f"slots={slots} do not fit in a block's {SMEM_BYTES} bytes of "
                         "shared memory")
    return tile


def _check(x: torch.Tensor, iters: int, chunk_rows: int, slots: int) -> None:
    """The reference's contract, then what a bulk copy takes."""
    if x.dim() != 2:
        raise ValueError(f"dma_pipeline_copy takes a (rows, cols) tensor, got {tuple(x.shape)}")
    rows = x.shape[0]
    if chunk_rows < 1 or rows % chunk_rows:
        # a remainder tail would never be copied
        raise ValueError(f"rows={rows} not divisible by chunk_rows={chunk_rows}")
    num_chunks = rows // chunk_rows
    if not 1 <= slots <= num_chunks:
        raise ValueError(f"slots={slots} outside [1, {num_chunks}]")
    if iters < 1:
        raise ValueError(f"iters={iters}: at least one pass writes the output")
    if not x.is_contiguous():
        raise ValueError("dma_pipeline_copy takes a contiguous tensor")
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"a row of {row_bytes} bytes: bulk copies move multiples of 16 bytes")
    if x.data_ptr() % 16:
        raise ValueError("x is not 16-byte aligned: bulk copies need 16-byte addresses")


def _bind() -> ctypes.CDLL:
    lib, _ = _build.library("dma_pipeline")
    fn = lib.tpu_dma_pipeline_copy
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def dma_pipeline_copy(x: torch.Tensor, iters: int, chunk_rows: int, slots: int) -> torch.Tensor:
    """Copy ``x`` through the DMA pipeline ``iters`` times; returns the copy
    (bit-identical to ``x``).  Through the CUDA kernel for a tensor on a
    card (launched on the current stream, not synchronized); the plain
    version for a tensor on the CPU."""
    global launches
    _check(x, iters, chunk_rows, slots)
    tile = tile_bytes(x, chunk_rows, slots)
    if x.device.type == "cpu":
        return dma_pipeline_copy_reference(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"dma_pipeline_copy runs on cuda or cpu, not {x.device}")
    lib = _bind()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tpu_dma_pipeline_copy(
            x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(), tile, slots, iters,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"dma_pipeline kernel launch failed: cudaError {rc}")
    launches += 1
    return out
