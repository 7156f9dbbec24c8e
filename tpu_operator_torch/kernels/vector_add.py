"""The readiness gate's vector-add kernel (``csrc/vector_add.cu``) and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``_add_kernel`` / ``pallas_vector_add``
(``tpu_operator/workloads/collectives.py:96-115``), in the reference's
dtypes: f32, bf16 and f16, each bit-identical to ``x + y``.
"""

from __future__ import annotations

import torch

from tpu_operator_torch.kernels import _build

# the dtype codes of tpu_vector_add in csrc/vector_add.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def vector_add_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain version: one elementwise add."""
    return x + y


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.dtype != y.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError("vector_add_kernel takes two tensors of one dtype among float32, "
                        f"bfloat16 and float16, got {x.dtype} and {y.dtype}")
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} vs {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("vector_add_kernel takes contiguous tensors")


def vector_add_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` through the CUDA kernel for tensors on a card (launched on
    the current stream, not synchronized); the plain version for tensors on
    the CPU."""
    _check(x, y)
    if x.device.type == "cpu":
        return vector_add_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"vector_add_kernel runs on cuda or cpu, not {x.device}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _build.launch("tpu_vector_add", x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                  x.numel(), DTYPE_CODES[x.dtype])
    return out
