"""attn_kernels_roofline: B3 f32 and B4 f32 together, their least time
(FLOPs over the TF32 peak or bytes over the memory rate, by hop) over
their device time in the traced steps, every rank."""

from benchmark import readings


def read(ctx):
    return readings.attention_share(ctx, "both")
