"""lm.moe_experts.fp32_peak_share: the held experts' GEMM FLOPs in the
traced steps (the pairs the ``train.moe`` spans count, three SwiGLU
products forward and six backward, ``counts_lm.expert_pair_flops``) over
the device time attributed to ``train.moe.experts`` (gathers, products,
weighting and scatter, forward and backward), against the 67 TFLOP/s
float32 CUDA-core peak."""

from benchmark import counts_lm, peaks


def read(ctx):
    lm = ctx.get("lm") or {}
    spans, load = lm.get("spans"), lm.get("load")
    card = peaks.for_card(ctx.get("device_kind", ""))
    if not spans or not load or card is None or not load.get("routed_pairs"):
        return None
    seconds = spans.get("train.moe.experts", 0.0)
    if seconds <= 0:
        return None
    flops = load["routed_pairs"] * counts_lm.expert_pair_flops(lm["d_model"], lm["expert_width"])
    return 100.0 * flops / seconds / card["fp32_flops"]
