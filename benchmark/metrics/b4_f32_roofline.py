"""b4_f32_roofline: kernel B4's f32 block backward (its dK/dV and dQ
kernels) alone, its least time over its device time in the traced steps."""

from benchmark import readings


def read(ctx):
    return readings.attention_share(ctx, "b4")
