"""device.idle_share.train: the share of the traced steps' window in
which no operation ran on rank 0's card, from the profiler's trace."""

from benchmark import readings


def read(ctx):
    summaries = ctx.get("trace") or []
    return readings.idle_share(summaries[0]) if summaries else None
