"""What the per-layer readers share: the traced kernels of the training
step and their least time by ``counts``, against ``peaks``."""

from __future__ import annotations

from typing import Optional

from benchmark import counts, peaks
from benchmark import trace as btrace

# kernel names in the device trace (csrc/flash_backward.cu's f32 entries)
B3_F32 = r"\bfold_f32_kernel\b"
B4_F32 = (r"\bdkdv_kernel<float\b", r"\bdq_kernel<float\b")
NCCL = r"(?i)nccl"


def attention_share(ctx: dict, kernels: str) -> Optional[float]:
    """Σ least time / Σ device time, in %, of B3 f32 (``"b3"``), B4 f32
    (``"b4"``) or both (``"both"``) over every traced rank: the least time
    of each launch from its hop's shapes, the TF32 peak and the memory
    rate.  None when the trace is missing, the card has no peaks on
    record, or a rank's launches are not one a hop of each traced step."""
    summaries, attn = ctx.get("trace"), ctx.get("attn")
    card = peaks.for_card(ctx.get("device_kind", ""))
    if not summaries or not attn or card is None:
        return None
    steps = ctx["traced_steps"]
    bh, t, d = attn["bh"], attn["block"], attn["d_head"]
    bound = seconds = 0.0
    for summary, hops in zip(summaries, attn["hops"]):
        parts = []
        if kernels in ("b3", "both"):
            parts.append(([B3_F32], counts.b3_f32_work))
        if kernels in ("b4", "both"):
            parts.append((list(B4_F32), counts.b4_f32_work))
        for patterns, work in parts:
            for pattern in patterns:
                s, launches = btrace.matching(summary, pattern)
                if launches != steps * len(hops):
                    return None
                seconds += s
            for q_off, k_off in hops:
                flops, nbytes = work(bh, t, t, d, q_off, k_off)
                bound += steps * counts.bound_s(flops, nbytes, card["tf32_flops"],
                                                card["hbm_bytes_per_s"])
    return 100.0 * bound / seconds if seconds > 0 else None


def device_share(summary: dict, pattern: str) -> Optional[float]:
    """The share, in %, of one trace's device time in the operations whose
    name matches ``pattern``; None without device time."""
    total = summary.get("device_s", 0.0) if summary else 0.0
    if total <= 0:
        return None
    return 100.0 * btrace.matching(summary, pattern)[0] / total


def idle_share(summary: dict) -> Optional[float]:
    """The share, in %, of the traced window in which no operation ran on
    the card; None without a window or without device time."""
    if not summary or summary.get("window_s", 0.0) <= 0 or summary.get("busy_s", 0.0) <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
