"""attn_kernels.device_share: B3 f32 and B4 f32's device time over all
device time in the traced steps, every rank's summed."""

from benchmark import readings
from benchmark import trace as btrace


def read(ctx):
    summaries = ctx.get("trace") or []
    total = sum(s.get("device_s", 0.0) for s in summaries)
    if total <= 0:
        return None
    pattern = "|".join((readings.B3_F32,) + readings.B4_F32)
    return 100.0 * sum(btrace.matching(s, pattern)[0] for s in summaries) / total
