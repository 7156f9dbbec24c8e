"""lm.attn_kernels.device_share: B3 f32 and B4 f32's device time, causal
and windowed, over all device time in the language model's traced steps."""

from benchmark import readings_lm


def read(ctx):
    return readings_lm.device_share(ctx)
