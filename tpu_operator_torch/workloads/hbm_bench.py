"""Device-memory streaming probe.  Port of
``tpu_operator/workloads/hbm_bench.py`` (``:45-156``).

The memory leg of the perf probes, beside matmul's MFU and the ring's link
rate.  Methodology as the reference: ``iters`` elementwise scales of one
large f32 buffer back to back, ending in one scalar readback; the launch and
readback floor, measured by a null program, is subtracted; best-of-N
reported.  Each pass reads and writes the whole buffer, so bytes =
2 · size · iters.  The first pass scales ``x`` into a work buffer and the
rest scale that buffer in place (``mul_``), so ``x`` stays all ones and no
pass moves more than one read and one write.  The multiplier is 1.0000001,
not 1.0, as the reference's (an identity would be no work).

The default buffer (256 MiB) is five times the card's 50 MB L2, so the
traffic streams device memory.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from tpu_operator_torch.k8s import nodeinfo
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.workloads import resolve_device, timing

SCALE = 1.0000001  # rounds to 1 + 2^-23 in f32


def scale_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` passes of ``* SCALE`` over ``x``: the first into a new
    buffer, the rest in place.  Returns the buffer."""
    y = x * SCALE
    for _ in range(iters - 1):
        y.mul_(SCALE)
    return y


def hbm_benchmark(
    size_mb: float = 256.0,
    iters: int = 1024,
    best_of: int = 3,
    device=None,
) -> dict:
    """Stream a buffer through device memory; report achieved GB/s and the
    fraction of the card's data-sheet rate."""
    device = resolve_device(device)
    n = max(1024, int(size_mb * 1024 * 1024 / 4))  # f32 = 4 bytes
    x = torch.ones(n, dtype=torch.float32, device=device)

    def null() -> float:
        # same launch + scalar-readback shape as the timed program
        return float(x[0] + x[n // 2])

    def chain() -> float:
        y = scale_chain(x, iters)
        return float(y[0] + y[n // 2])

    null()
    compile_s = timing.timed(chain, device)  # first use + warm
    flight.record("hbm", "compile", compile_s=compile_s)
    floor = min(timing.timed(null, device) for _ in range(max(2, best_of)))
    nbytes = x.numel() * x.element_size()
    moved = 2 * nbytes * iters  # read + write per pass
    raw = []
    for rep in range(best_of):
        raw.append(timing.timed(chain, device))
        flight.record("hbm", "step", step=rep, step_s=raw[-1], gbps=moved / raw[-1] / 1e9)
        flight.record_step(
            "hbm", step_seq=rep, wall_s=raw[-1],
            phases={obs_profile.PHASE_COMPUTE: raw[-1]},
        )
    raw = sorted(raw)
    times, overhead_dominated = timing.subtract_floor(raw, floor)
    dt = times[0]
    dt_median = times[len(times) // 2]

    gbps = moved / dt / 1e9
    generation = nodeinfo.detect_generation(device)
    peak = _peak_hbm_gbps(generation)
    return {
        "ok": True,
        "size_mb": nbytes / 1e6,
        "iters": iters,
        "best_of": best_of,
        "time_ms": dt * 1e3,
        "overhead_ms": floor * 1e3,
        "overhead_dominated": overhead_dominated,
        "gbps": gbps,
        "gbps_median": moved / dt_median / 1e9,
        "gbps_min": moved / times[-1] / 1e9,
        "generation": generation,
        "peak_hbm_gbps": peak,
        "fraction_of_peak": round(gbps / peak, 4) if peak else None,
        "backend": device.type,
    }


def _peak_hbm_gbps(generation: str) -> float:
    return nodeinfo.generation_info(generation).hbm_gbps


def quick_benchmark(device=None) -> dict:
    """The in-process perf probe: the full-size stream on a card; a toy
    buffer (8 MB, 4 passes) on the CPU so tests stay fast."""
    device = resolve_device(device)
    if device.type == "cuda":
        return hbm_benchmark(device=device)
    return hbm_benchmark(size_mb=8.0, iters=4, best_of=2, device=device)


def apply_hbm_gate(result: dict, min_gbps: float) -> dict:
    """HBM_MIN_GBPS gate (shared rule: timing.apply_min_gate; no link
    requirement — the stream is card-local by construction)."""
    return timing.apply_min_gate(
        result, metric="gbps", minimum=min_gbps,
        backends_env="HBM_GATE_BACKENDS", label="hbm",
    )


def main() -> int:
    from tpu_operator_torch.validator import status as vstatus

    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = hbm_benchmark(
            size_mb=float(os.environ.get("HBM_SIZE_MB", "256")),
            iters=int(os.environ.get("HBM_ITERS", "1024")),
            best_of=int(os.environ.get("HBM_BEST_OF", "3")),
        )
        apply_hbm_gate(result, float(os.environ.get("HBM_MIN_GBPS", "0") or 0))
        flight.record_result("hbm", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
