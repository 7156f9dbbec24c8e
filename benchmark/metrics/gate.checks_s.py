"""gate.checks_s: the sum of a gate pass's checks' ``duration_s`` (the
entry's monotonic clock around each check, which ends in a read-back):
vector-add with the CUDA context's start and B1's library load, then the
allreduce.  Mean over the window's passes."""


def read(ctx):
    passes = ctx.get("passes") or []
    if not passes:
        return None
    return sum(p["checks_s"] for p in passes) / len(passes)
