"""The readiness gate's vector-add kernel (``csrc/vector_add.cu``) and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``_add_kernel`` / ``pallas_vector_add``
(``tpu_operator/workloads/collectives.py:96-115``).  f32 only for now.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_operator_torch.kernels import _build

# launches of the CUDA kernel in this process: a run shows it went through
# the kernel by reading this before and after (chip_smoke.py sets it to 0)
launches = 0


def vector_add_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain version: one elementwise add."""
    return x + y


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"vector_add_kernel takes float32, got {x.dtype} and {y.dtype}")
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} vs {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("vector_add_kernel takes contiguous tensors")


def _bind() -> ctypes.CDLL:
    lib, _ = _build.library("vector_add")
    fn = lib.tpu_vector_add_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def vector_add_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` through the CUDA kernel for tensors on a card (launched on
    the current stream, not synchronized); the plain version for tensors on
    the CPU."""
    global launches
    _check(x, y)
    if x.device.type == "cpu":
        return vector_add_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"vector_add_kernel runs on cuda or cpu, not {x.device}")
    lib = _bind()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tpu_vector_add_f32(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), stream
        )
    if rc != 0:
        raise RuntimeError(f"vector_add kernel launch failed: cudaError {rc}")
    launches += 1
    return out
