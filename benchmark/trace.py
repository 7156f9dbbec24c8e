"""Reads a ``torch.profiler`` trace (its Chrome-trace export) of one traced
window: the device's busy seconds, the time of each device operation, and
the idle gaps with what the host was doing in them.

The window is the host annotation ``WINDOW`` the caller wraps around the
traced work and a synchronize.  Device operations are the trace's kernels,
copies and sets; busy is the union of their intervals inside the window,
so overlapping streams count once."""

from __future__ import annotations

import heapq
import json
import os
import re
import tempfile

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, arguments and
    template arguments: ``void (anonymous namespace)::dq_kernel<float, 2>(P)``
    reads ``dq_kernel<float, 2>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(", 1)
    if cut > 0:
        name = name[:cut]
    return name[:100]


def _merged(intervals: list) -> list:
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def summarize(events: list, window: str = WINDOW) -> dict:
    """The summary of one process's trace events: ``window_s``, ``busy_s``,
    ``ops`` (device seconds and count by full name), ``gaps`` (idle
    seconds by the innermost host operation running when each gap began).
    An empty dict when the trace has no window annotation."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window
             and e.get("cat") == "user_annotation"]
    if not spans:
        return {}
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            start, end = max(start, w0), min(end, w1)
            if end > start:
                device.append((start, end, e.get("name", "")))
        elif cat in HOST_CATS and e.get("name") != window:
            host.append((start, end, e.get("name", "")))
    ops: dict = {}
    for start, end, name in device:
        seconds, count = ops.get(name, (0.0, 0))
        ops[name] = (seconds + (end - start) * 1e-6, count + 1)
    busy = _merged([(s, e) for s, e, _ in device])
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    started: list = []  # max-heap by start of the host operations begun so far
    i = 0
    for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
        if gap_end <= gap_start:
            continue
        while i < len(host) and host[i][0] <= gap_start:
            heapq.heappush(started, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        # gaps come in order, so an operation ended before this one began
        # covers no later gap either
        while started and started[0][1] <= gap_start:
            heapq.heappop(started)
        what = started[0][2] if started else "(no host operation)"
        gaps[what] = gaps.get(what, 0.0) + (gap_end - gap_start) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_s": sum(seconds for seconds, _ in ops.values()),
        "ops": {name: list(v) for name, v in ops.items()},
        "gaps": gaps,
    }


def summarize_profile(prof) -> dict:
    """``summarize`` of a finished ``torch.profiler.profile``: its Chrome
    trace is written to a temporary file under TMPDIR, read and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="benchmark-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize(events)


def matching(summary: dict, pattern: str) -> tuple:
    """(seconds, launches) of the device operations whose name matches the
    regular expression ``pattern``."""
    rx = re.compile(pattern)
    seconds, count = 0.0, 0
    for name, (s, n) in summary.get("ops", {}).items():
        if rx.search(name):
            seconds += s
            count += n
    return seconds, count


def top(table: dict, n: int = 10) -> list:
    """The ``n`` largest entries of a name -> seconds table, largest first."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(summaries: list) -> dict:
    """The result line's ``breakdown``: device operations by short name and
    idle gaps by host operation, each the mean over the traced processes
    (one a card), the ten largest."""
    ops: dict = {}
    gaps: dict = {}
    n = max(1, len(summaries))
    for s in summaries:
        for name, (seconds, _) in s.get("ops", {}).items():
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + seconds / n
        for name, seconds in s.get("gaps", {}).items():
            gaps[name] = gaps.get(name, 0.0) + seconds / n
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
