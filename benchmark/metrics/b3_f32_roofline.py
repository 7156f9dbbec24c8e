"""b3_f32_roofline: kernel B3's f32 fold (the ring attention's forward)
alone, its least time over its device time in the traced steps."""

from benchmark import readings


def read(ctx):
    return readings.attention_share(ctx, "b3")
