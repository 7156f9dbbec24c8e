"""Device time of a traced window by span of the language model's train
step (``workloads/lm.py``): every ``train.*`` range, the innermost around
each launch, a backward launch going to the range around the forward op
that made its node, as ``phases.attribute`` gives its three blocks (whose
launch mapping this reuses).  ``phases.attribute`` keeps only the probe's
blocks (``train.attn``, ``train.mlp``, ``train.grads``); the model's
``train.ffn``, ``train.moe`` and its parts and ``train.head`` are read
here."""

from __future__ import annotations

from benchmark import phases
from benchmark import trace as btrace


def attribute(events: list, window: str = btrace.WINDOW) -> dict:
    """{span name: device seconds} over the window's device operations, the
    rest under ``phases.NONE``; {} when the window holds no ``train.*``
    range."""
    bounds = phases._window(events, window)
    if bounds is None:
        return {}
    w0, w1 = bounds
    launches, forward = phases._launches(events)
    out: dict = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if str(e.get("cat", "")).lower() not in btrace.DEVICE_CATS:
            continue
        start, end = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if end <= start:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        name = None
        if launch is not None:
            kind, value = launch
            name = value if kind == "direct" else forward.get(value)
        name = name or phases.NONE
        out[name] = out.get(name, 0.0) + (end - start) * 1e-6
    return out if set(out) - {phases.NONE} else {}


def share(table: dict, prefix: str) -> float:
    """The share, in %, of the attributed device time in spans named
    ``prefix`` or ``prefix.*``; None without device time."""
    total = sum(table.values())
    if total <= 0:
        return None
    mine = sum(s for name, s in table.items() if name == prefix or name.startswith(prefix + "."))
    return 100.0 * mine / total
