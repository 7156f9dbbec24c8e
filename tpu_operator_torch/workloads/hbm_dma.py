"""DMA-pipeline device-memory streaming cross-check.  Port of
``tpu_operator/workloads/hbm_pallas.py`` (``:120-210``), named for what it
measures: no Pallas is left in it.

A second methodology for the memory rate beside ``hbm_bench``'s elementwise
stream: the buffer moves global → shared → global through the copy engines
alone (TMA bulk copies in a ``slots``-deep ring, kernel B2,
``kernels/dma_pipeline.py``), with no arithmetic unit touching the data.
If the two figures diverge on a degraded node, the fault is in the compute
pipeline rather than the memory system, or the reverse.

Timing follows the shared rule (``timing``): ``iters`` full passes inside
ONE launch, the launch and readback floor subtracted, best-of-N.  The
reference's sizing rules are kept: ``chunk_rows`` from ``chunk_mb``, the
rows rounded down to whole chunks, ``slots`` clamped to the chunk count.
The kernel streams tiles of at most 32 KiB (``tile_bytes`` in the result)
because a TPU-sized chunk does not fit in a block's shared memory.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from tpu_operator_torch.k8s import nodeinfo
from tpu_operator_torch.kernels.dma_pipeline import dma_pipeline_copy, tile_bytes
from tpu_operator_torch.workloads import resolve_device, timing

_COLS = 512  # the reference's lanes; a chunk is chunk_rows x 512 f32


def dma_stream_benchmark(
    size_mb: float = 256.0,
    iters: int = 1024,
    chunk_mb: float = 4.0,
    slots: int = 4,
    best_of: int = 3,
    device=None,
) -> dict:
    """Stream a buffer through the DMA pipeline; report achieved GB/s and
    the fraction of the card's data-sheet memory rate."""
    device = resolve_device(device)
    chunk_rows = max(8, int(chunk_mb * 1024 * 1024 / 4 / _COLS))
    rows = max(chunk_rows, int(size_mb * 1024 * 1024 / 4 / _COLS))
    rows -= rows % chunk_rows
    slots = max(1, min(slots, rows // chunk_rows))
    x = torch.ones((rows, _COLS), dtype=torch.float32, device=device)

    def run() -> torch.Tensor:
        return dma_pipeline_copy(x, iters, chunk_rows, slots)

    def null() -> float:
        return float(x[0, 0] + x[rows // 2, 0])

    y = run()  # first use (the kernel's build and load) + warm
    # full-buffer self-check: min == max == 1.0 reads every element, so a
    # kernel that skips an interior tile (leaving it uninitialized) fails
    # here; a trailing-element probe would not
    lo, hi = torch.aminmax(y)
    if float(lo) != 1.0 or float(hi) != 1.0:
        return {"ok": False, "error": "DMA pipeline copy produced wrong data",
                "backend": device.type}
    del y
    null()
    floor = min(timing.timed(null, device) for _ in range(max(2, best_of)))
    raw = sorted(timing.timed(run, device) for _ in range(best_of))
    times, overhead_dominated = timing.subtract_floor(raw, floor)
    nbytes = x.numel() * x.element_size()
    moved = 2 * nbytes * iters  # read + write per pass
    generation = nodeinfo.detect_generation(device)
    peak = nodeinfo.generation_info(generation).hbm_gbps
    gbps = moved / times[0] / 1e9
    return {
        "ok": True,
        # the reference's name for the method, kept so the two compare
        "methodology": "pallas-dma-pipeline",
        "kernel": "cuda-dma" if device.type == "cuda" else "plain",
        "size_mb": nbytes / 1e6,
        "iters": iters,
        "chunk_mb": chunk_rows * _COLS * 4 / 1e6,
        "tile_bytes": tile_bytes(x, chunk_rows, slots),
        "slots": slots,
        "best_of": best_of,
        "time_ms": times[0] * 1e3,
        "overhead_ms": floor * 1e3,
        "overhead_dominated": overhead_dominated,
        "gbps": gbps,
        "gbps_median": moved / times[len(times) // 2] / 1e9,
        "generation": generation,
        "peak_hbm_gbps": peak,
        "fraction_of_peak": round(gbps / peak, 4) if peak else None,
        "backend": device.type,
    }


def quick_benchmark(device=None) -> dict:
    """The validator's cross-check probe: full size on a card (comparable
    to hbm_bench's figure); the reference's toy shapes on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return dma_stream_benchmark(device=device)
    return dma_stream_benchmark(size_mb=0.5, iters=2, chunk_mb=0.125, slots=2, best_of=2,
                                device=device)


def main() -> int:
    result = dma_stream_benchmark(
        size_mb=float(os.environ.get("HBM_SIZE_MB", "256")),
        iters=int(os.environ.get("HBM_ITERS", "1024")),
        chunk_mb=float(os.environ.get("HBM_DMA_CHUNK_MB", "4")),
        slots=int(os.environ.get("HBM_DMA_SLOTS", "4")),
        best_of=int(os.environ.get("HBM_BEST_OF", "3")),
    )
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
