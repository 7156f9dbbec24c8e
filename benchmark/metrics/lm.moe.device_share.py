"""lm.moe.device_share: the device time that the traced steps spend in
the expert layers (``train.moe`` and its parts, forward and backward, by
``phases_lm.attribute``) over all their attributed device time."""

from benchmark import phases_lm


def read(ctx):
    spans = (ctx.get("lm") or {}).get("spans")
    return phases_lm.share(spans, "train.moe") if spans else None
