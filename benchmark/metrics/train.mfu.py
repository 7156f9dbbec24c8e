"""train.mfu: the window's model FLOPs (``counts.step_model_flops`` of the
global batch, x the steps) over the window's seconds, over the dense bf16
peak of every card: the whole step's share of the cards' top rate."""

from benchmark import peaks


def read(ctx):
    card = peaks.for_card(ctx.get("device_kind", ""))
    if card is None or not ctx.get("window_s"):
        return None
    rate = ctx["steps"] * ctx["flops_per_step"] / ctx["window_s"]
    return 100.0 * rate / (card["bf16_flops"] * ctx["cards"])
