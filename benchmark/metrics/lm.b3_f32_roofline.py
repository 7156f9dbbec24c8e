"""lm.b3_f32_roofline: kernel B3's f32 fold (causal in the global layer,
windowed in the sliding ones) alone over every layer of the language
model, its least time over its device time in the traced steps."""

from benchmark import readings_lm


def read(ctx):
    return readings_lm.attention_share(ctx, ("b3",))
