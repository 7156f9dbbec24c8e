"""gate.start_s: a gate pass's wall, spawn to exit, less its checks' own
``duration_s``: the interpreter's start, the imports (torch), the device
count, the tracer and flight recorder, the drop-box and the exit.  Mean
over the window's passes."""


def read(ctx):
    passes = ctx.get("passes") or []
    if not passes:
        return None
    return sum(p["wall_s"] - p["checks_s"] for p in passes) / len(passes)
