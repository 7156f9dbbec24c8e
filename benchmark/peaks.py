"""Data-sheet peaks of the cards the benchmark runs on: NVIDIA's H100 SXM5
data sheet, dense rates without sparsity, at the full 700 W (a copy of the
``h100-sxm`` row of the port's ``k8s/nodeinfo.py``; the program's table may
change, this one does not)."""

from __future__ import annotations

from typing import Optional

H100_SXM = {
    "bf16_flops": 989.0e12,   # tensor cores, bf16 and fp16
    "tf32_flops": 494.5e12,   # tensor cores, TF32: the fastest entry of f32 operands
    "fp32_flops": 67.0e12,    # CUDA cores
    "hbm_bytes_per_s": 3350.0e9,
}

# substrings of torch.cuda.get_device_name(); the SXM part reports itself
# as "NVIDIA H100 80GB HBM3", the other H100 parts name themselves
_CARDS = (("H100 NVL", None), ("H100 PCIe", None), ("H100", H100_SXM))


def for_card(name: str) -> Optional[dict]:
    """The peaks of the card named ``name``; None for a card not listed."""
    for pattern, peaks in _CARDS:
        if pattern in name:
            return peaks
    return None
