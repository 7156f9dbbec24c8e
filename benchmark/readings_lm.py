"""What the language model's per-layer readers share: kernels B3 f32 and
B4 f32 in its traced steps, causal in the global layers and windowed in
the sliding ones, and their least time from ``counts_lm``'s window-aware
pairs against ``peaks``."""

from __future__ import annotations

from typing import Optional

from benchmark import counts, counts_lm, peaks
from benchmark import trace as btrace

# the kernels' names in the device trace: the causal ones (a global layer's
# hop) and those with a window (a sliding layer's)
B3_F32 = r"\bfold_(f32|band)_kernel\b"
B4_F32 = (r"\bdkdv_(kernel<float\b|band_kernel\b)", r"\bdq_(kernel<float\b|band_kernel\b)")
KERNELS = {"b3": ((B3_F32,), counts_lm.b3_f32_work),
           "b4": (B4_F32, counts_lm.b4_f32_work)}


def attention_share(ctx: dict, kernels: tuple) -> Optional[float]:
    """Σ least time / Σ device time, in %, of ``kernels`` (``"b3"``,
    ``"b4"`` or both) over every layer of the traced steps.  None when the
    trace is missing, the card has no peaks on record, or a kernel did not
    launch once a layer a traced step."""
    summaries, lm = ctx.get("trace"), ctx.get("lm")
    card = peaks.for_card(ctx.get("device_kind", ""))
    if not summaries or not lm or card is None:
        return None
    steps, windows = ctx["traced_steps"], lm["windows"]
    bh = lm["batch"] * lm["heads"]
    bound = seconds = 0.0
    for key in kernels:
        patterns, work = KERNELS[key]
        for pattern in patterns:
            s, launches = btrace.matching(summaries[0], pattern)
            if launches != steps * len(windows):
                return None
            seconds += s
        for window in windows:
            flops, nbytes = work(bh, lm["seq"], lm["d_head"], window)
            bound += steps * counts.bound_s(flops, nbytes, card["tf32_flops"],
                                            card["hbm_bytes_per_s"])
    return 100.0 * bound / seconds if seconds > 0 else None


def device_share(ctx: dict) -> Optional[float]:
    """B3 f32 and B4 f32's device time over all device time in the traced
    steps, in %; None without a trace or without device time."""
    summaries = ctx.get("trace")
    if not summaries or not ctx.get("lm"):
        return None
    total = summaries[0].get("device_s", 0.0)
    if total <= 0:
        return None
    pattern = "|".join((B3_F32,) + B4_F32)
    return 100.0 * btrace.matching(summaries[0], pattern)[0] / total
