"""Single-card compute probe: a bf16 matmul chain → TFLOP/s → MFU.  Port of
``tpu_operator/workloads/matmul_bench.py`` (``:1-297``).

A dense bf16 matmul chain, timed best-of-N, reported as achieved TFLOP/s and
as MFU against the card's data-sheet dense bf16 peak
(``tpu_operator_torch/k8s/nodeinfo.py``).  The product is a plain GEMM that
the reference leaves to XLA's ``dot_general`` outside any Pallas kernel, so
here it is a library product (cuBLAS through ``torch.addmm``):

- bf16 inputs, f32 accumulation, the scale applied in f32 and one rounding
  to bf16, as the reference's ``preferred_element_type=f32`` product times
  ``inv`` cast to bf16: ``addmm``'s ``alpha`` is applied in the f32 compute
  type before the output is rounded.  Reduced-precision split-K reductions
  are turned off while the chain runs.
- the chain runs ``iters`` dependent products and reads back ONE scalar,
  the launch and readback floor measured by a null program is subtracted
  (``timing``), best-of-N reported with its spread.

Inputs come from an explicit ``torch.Generator`` seeded with the size; the
reference's ``jax.random`` draws cannot be reproduced without JAX, and
nothing depends on them.  ``main()`` prints one JSON line.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Optional, Sequence

import torch

from tpu_operator_torch.k8s import nodeinfo
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.workloads import resolve_device, timing

DEFAULT_SIZES = (1024, 2048, 4096, 8192)

# FLOPs per timed repetition: every size amortizes the launch and readback
# floor.  1e14 FLOPs take 0.10 s at the H100's data-sheet 989 TFLOP/s.
_FLOP_BUDGET = 1.0e14
_MAX_CHAIN_ITERS = 50_000
NORM_PERIOD = 8  # matmuls per RMS re-normalization (see _chain_fn)


def detect_generation(device=None) -> str:
    """Card generation from its CUDA name ("cpu" for the CPU)."""
    return nodeinfo.detect_generation(device)


def peak_bf16_tflops(generation: str) -> float:
    """Data-sheet dense bf16 peak of the generation (0 = unknown)."""
    return nodeinfo.generation_info(generation).peak_bf16_tflops


def _chain_fn(size: int, iters: int):
    """The chain of ``iters`` dependent matmuls: ``chain(c, b)`` returns
    (checksum, final c), the checksum a 0-dim f32 tensor (the sum of every
    element, so no element is dead) and c the final bf16 matrix.

    As the reference: a fixed 1/(2·sqrt(n)) scale keeps the product bounded
    within a burst of NORM_PERIOD steps, and one RMS pass per burst
    re-centres it (normalizing every step would serialize a reduction
    against each matmul)."""
    inv = 1.0 / (2.0 * size**0.5)

    def chain(c: torch.Tensor, b: torch.Tensor) -> tuple:
        for _ in range(iters // NORM_PERIOD):
            for _ in range(NORM_PERIOD):
                # beta=0: the first operand is not read, only its shape
                c = torch.addmm(c, c, b, beta=0.0, alpha=inv)
            o = c.float()
            o = o / (torch.sqrt(torch.mean(torch.square(o))) + 1e-30)
            c = o.to(torch.bfloat16)
        return c.float().sum(), c

    return chain


def chain_iters(size: int, flop_budget: float = _FLOP_BUDGET) -> int:
    raw = min(_MAX_CHAIN_ITERS, int(flop_budget / (2.0 * size**3)))
    # round up to a whole number of normalization bursts
    return max(1, -(-raw // NORM_PERIOD)) * NORM_PERIOD


def _time_matmul(
    size: int, iters: Optional[int], warmup: int, best_of: int, flop_budget: float,
    device: torch.device,
) -> dict:
    iters = iters if iters else chain_iters(size, flop_budget)
    iters = max(1, -(-iters // NORM_PERIOD)) * NORM_PERIOD  # whole bursts
    gen = torch.Generator(device=device).manual_seed(size)
    a, b = (torch.randn((size, size), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    chain = _chain_fn(size, iters)

    def run() -> float:
        return float(chain(a, b)[0])  # the scalar readback waits for the card

    def null() -> float:
        # launch + scalar-readback floor: the checksum's reduction, no chain
        return float(a.float().sum())

    null()
    overhead = min(timing.timed(null, device) for _ in range(3))

    compile_s = timing.timed(run, device)  # first use (cuBLAS handle, heuristics) + settle
    flight.record("matmul", "compile", compile_s=compile_s, size=size)
    for _ in range(max(1, warmup) - 1):
        run()
    raw = []
    checksum = 0.0
    flops = 2.0 * size * size * size
    for rep in range(best_of):
        timing.sync(device)
        t0 = time.perf_counter()
        checksum = run()
        raw.append(time.perf_counter() - t0)
        flight.record(
            "matmul", "step", step=rep, size=size, step_s=raw[-1],
            # amortized, floor-unsubtracted live rate (a monitoring signal)
            tflops=flops * iters / raw[-1] / 1e12,
        )
        flight.record_step(
            "matmul", step_seq=rep, wall_s=raw[-1],
            phases={obs_profile.PHASE_COMPUTE: raw[-1]},
        )
    # shared rule (timing.py): floor-subtract per-matmul time; when the floor
    # rivals the compute the number is flagged and never gated
    times, overhead_dominated = timing.subtract_floor(raw, overhead, per=iters)
    best = times[0]
    median = times[len(times) // 2]
    return {
        "size": size,
        "iters": iters,
        "overhead_ms": overhead * 1e3,
        "overhead_dominated": overhead_dominated,
        "time_ms": best * 1e3,
        "time_ms_median": median * 1e3,
        "tflops": flops / best / 1e12,
        "tflops_median": flops / median / 1e12,
        "tflops_min": flops / times[-1] / 1e12,
        "finite": math.isfinite(checksum),
    }


def matmul_benchmark(
    sizes: Sequence[int] = DEFAULT_SIZES,
    iters: Optional[int] = None,
    warmup: int = 1,
    best_of: int = 3,
    flop_budget: float = _FLOP_BUDGET,
    device=None,
) -> dict:
    """Sweep the sizes; report per-size TFLOP/s plus best-overall and MFU."""
    device = resolve_device(device)
    generation = detect_generation(device)
    peak = peak_bf16_tflops(generation)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        results = [
            _time_matmul(int(s), iters, warmup, best_of, flop_budget, device) for s in sizes
        ]
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    best = max(results, key=lambda r: r["tflops"])
    mfu = best["tflops"] / peak if peak else None
    return {
        "ok": all(r["tflops"] > 0 and r["finite"] for r in results),
        "backend": device.type,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "generation": generation,
        "peak_bf16_tflops": peak or None,
        "results": results,
        "best_size": best["size"],
        "overhead_dominated": best["overhead_dominated"],
        "tflops": best["tflops"],
        "tflops_spread": {
            "min": best["tflops_min"],
            "median": best["tflops_median"],
            "max": best["tflops"],
        },
        "mfu": round(mfu, 4) if mfu is not None else None,
        "mfu_median": round(best["tflops_median"] / peak, 4) if peak else None,
        "mfu_min": round(best["tflops_min"] / peak, 4) if peak else None,
    }


def apply_mfu_gate(result: dict, min_mfu: float) -> dict:
    """The MFU gate policy, shared by the CLI and run_validation: enforce
    only when a peak is known (mfu not None) and the best measurement was
    not overhead-dominated.  Mutates ``result`` with the outcome."""
    enforced = (
        min_mfu > 0
        and result.get("mfu") is not None
        and not result.get("overhead_dominated")
    )
    result["min_mfu"] = min_mfu
    result["gated"] = enforced
    if enforced and result["mfu"] < min_mfu:
        result["ok"] = False
        result["error"] = f"mfu {result['mfu']:.3f} < required {min_mfu}"
    return result


def quick_benchmark(device=None) -> dict:
    """The validator's perf probe: sizes 2048 and 4096 at the full flop
    budget on a card (the exported figure is best-over-sizes, as bench.py's
    sweep); a toy size on the CPU so tests stay fast."""
    device = resolve_device(device)
    if device.type == "cuda":
        return matmul_benchmark(sizes=(2048, 4096), flop_budget=_FLOP_BUDGET, device=device)
    return matmul_benchmark(sizes=(256,), iters=NORM_PERIOD, best_of=2, device=device)


def main() -> int:
    from tpu_operator_torch.validator import status as vstatus

    sizes = tuple(
        int(s) for s in os.environ.get("MATMUL_SIZES", "").split(",") if s.strip()
    ) or DEFAULT_SIZES
    iters_env = os.environ.get("MATMUL_ITERS", "")
    with flight.activate(flight.recorder_for(vstatus.flight_record_path())):
        result = matmul_benchmark(
            sizes=sizes,
            iters=int(iters_env) if iters_env else None,
            best_of=int(os.environ.get("MATMUL_BEST_OF", "3")),
        )
        apply_mfu_gate(result, float(os.environ.get("MATMUL_MIN_MFU", "0")))
        flight.record_result("matmul", result)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
