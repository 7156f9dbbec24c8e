"""lm.attn_kernels_roofline: kernels B3 f32 and B4 f32 over every layer of
the language model, their least time (FLOPs of the pairs the causal mask
and each layer's window keep, over the TF32 peak, or bytes over the memory
rate, ``counts_lm``) over their device time in the traced steps.  None
unless each kernel launched once a layer a traced step."""

from benchmark import readings_lm


def read(ctx):
    return readings_lm.attention_share(ctx, ("b3", "b4"))
