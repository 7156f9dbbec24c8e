"""nccl.device_share: NCCL's kernels' device time on rank 0 over all its
device time in the traced steps.  Nothing to read where no NCCL kernel
ran (one card)."""

from benchmark import readings
from benchmark import trace as btrace


def read(ctx):
    summaries = ctx.get("trace") or []
    if not summaries or btrace.matching(summaries[0], readings.NCCL)[1] == 0:
        return None
    return readings.device_share(summaries[0], readings.NCCL)
