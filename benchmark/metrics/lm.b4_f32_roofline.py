"""lm.b4_f32_roofline: kernel B4's f32 block backward (its dK/dV and dQ
kernels, causal in the global layer, windowed in the sliding ones) alone
over every layer of the language model, its least time over its device
time in the traced steps."""

from benchmark import readings_lm


def read(ctx):
    return readings_lm.attention_share(ctx, ("b4",))
