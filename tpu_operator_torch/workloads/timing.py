"""Shared timing rules for the gate's measurements: own copy of
``tpu_operator/workloads/timing.py``'s probe, floor subtraction, gate and
round-over-round verdict.

PyTorch launches work asynchronously, and a collective can run on a stream
of its own, so a timed region on the card ends in a device synchronize:
without it the floor subtraction compares enqueue times.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


def gate_backends(env_var: str, default: str = "cuda") -> list[str]:
    """Backends a gate is enforced on: CPU/gloo numbers say nothing about
    card health, so gates default to cuda only; tests widen via the env
    var."""
    return [b.strip() for b in os.environ.get(env_var, default).split(",")]


def sync(device: Optional[torch.device]) -> None:
    """Wait for every stream of ``device`` when it is a card; no-op on the
    CPU."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: Optional[torch.device] = None) -> float:
    """Wall-clock one call, synchronizing the card before the clock stops
    when ``device`` is one."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def subtract_floor(
    raw: list[float], floor: float, per: int = 1
) -> tuple[list[float], bool]:
    """(sorted per-unit times with the floor subtracted, overhead_dominated).

    When the floor rivals the raw measurement (floor > raw/2, or subtraction
    goes non-positive) the measurement is flagged overhead-dominated — the
    per-unit times then fall back to the raw amortized values, and callers
    must never gate on a flagged number in either direction."""
    times = sorted((t - floor) / per for t in raw)
    dominated = times[0] <= 0 or floor > 0.5 * min(raw)
    if dominated:
        times = sorted(t / per for t in raw)
    return times, dominated


def regression_verdict(
    current,
    prior,
    threshold: float = 0.07,
    higher_is_better: bool = True,
) -> Optional[dict]:
    """The one round-over-round comparison rule: relative delta against the
    prior value, verdict ``improved`` / ``flat`` / ``regressed`` outside or
    inside the ``threshold`` band.  None when either side is unusable
    (missing, zero prior, non-numeric)."""
    if (
        not isinstance(current, (int, float))
        or not isinstance(prior, (int, float))
        or isinstance(current, bool)
        or isinstance(prior, bool)
        or prior == 0
    ):
        return None
    delta = (current - prior) / abs(prior)
    signed = delta if higher_is_better else -delta
    if signed >= threshold:
        verdict = "improved"
    elif signed <= -threshold:
        verdict = "regressed"
    else:
        verdict = "flat"
    return {
        "verdict": verdict,
        "current": current,
        "prior": prior,
        "delta_pct": round(delta * 100, 2),
    }


def apply_min_gate(
    result: dict,
    *,
    metric: str,
    minimum: float,
    backends_env: str,
    label: str,
    require_interconnect: bool = False,
) -> dict:
    """The bandwidth-gate enforcement rule, in one place:

    - enforce only when a positive minimum is set
    - only on backends named in the ``backends_env`` env var (default cuda)
    - with ``require_interconnect``, only over a real card-to-card link
      (``transport == "nvlink"``; single-card HBM copy rates are never gated
      as link rates)
    - never when the measurement was overhead-dominated

    Mutates ``result``: records the minimum under ``min_gbps`` and whether
    the gate was ``gated`` (enforced), and flips ``ok`` on a miss."""
    backends = gate_backends(backends_env)
    enforced = (
        minimum > 0
        and (not require_interconnect or result.get("transport") == "nvlink")
        and result.get("backend") in backends
        and not result.get("overhead_dominated")
    )
    result["min_gbps"] = minimum
    result["gated"] = enforced
    if enforced and result[metric] < minimum:
        result["ok"] = False
        result["error"] = (
            f"{label} {result[metric]:.1f} GB/s below required {minimum:g}"
        )
    return result
