"""Accelerator catalogue for NVIDIA cards: the port's counterpart of the
TPU table in ``tpu_operator/k8s/nodeinfo.py``.

The peaks are NVIDIA's data-sheet numbers, dense (no sparsity), at the
card's full power limit; a card set below it runs slower under load.  They
are the denominators of the port's roofline and bandwidth shares, never
measurements.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AcceleratorInfo:
    generation: str          # h100-sxm | h100-pcie | h100-nvl | h200
    hbm_gb: int              # device memory per card (GB)
    peak_bf16_tflops: float  # dense bf16 tensor-core peak
    hbm_gbps: float          # device memory bandwidth, GB/s
    peak_fp32_tflops: float = 0.0  # f32 on the CUDA cores, outside the tensor cores


ACCELERATORS: dict[str, AcceleratorInfo] = {
    "h100-sxm": AcceleratorInfo("h100-sxm", 80, 989.0, 3350.0, 67.0),
    "h100-pcie": AcceleratorInfo("h100-pcie", 80, 756.0, 2000.0, 51.0),
    "h100-nvl": AcceleratorInfo("h100-nvl", 94, 835.0, 3900.0, 60.0),
    "h200": AcceleratorInfo("h200", 141, 989.0, 4800.0, 67.0),
}

UNKNOWN_ACCELERATOR = AcceleratorInfo("unknown", 0, 0.0, 0.0)

# substrings of torch.cuda.get_device_name, most specific first (the SXM
# part reports itself as "NVIDIA H100 80GB HBM3")
_NAME_PATTERNS = (
    ("H100 NVL", "h100-nvl"),
    ("H100 PCIe", "h100-pcie"),
    ("H200", "h200"),
    ("H100", "h100-sxm"),
)


def generation_info(generation: str) -> AcceleratorInfo:
    """Peaks by generation; zeros for one not in the table."""
    return ACCELERATORS.get(generation, UNKNOWN_ACCELERATOR)


def generation_of(name: str) -> str:
    """Generation from a card name as CUDA reports it; "unknown" when no
    pattern matches."""
    for pattern, generation in _NAME_PATTERNS:
        if pattern in name:
            return generation
    return "unknown"


def detect_generation(device=None) -> str:
    """Generation of ``device`` (default: the current card); "cpu" for the
    CPU."""
    device = torch.device(device) if device is not None else torch.device("cuda")
    if device.type == "cpu":
        return "cpu"
    return generation_of(torch.cuda.get_device_name(device))
