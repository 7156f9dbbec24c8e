"""Device time of a traced window by block of the train step, from the
profiler's Chrome-trace events of one rank.

The program opens spans ``train.step`` and, inside it, ``train.attn``,
``train.mlp`` and ``train.grads`` (the loss, its gradient, the sums and the
update; ``workloads/collectives.py``); under the profiler each is a
``user_annotation`` range on the host thread that opened it.  A device
operation (a kernel, copy or set) goes to a phase by its launch, the
runtime or driver call of the same ``correlation``:

- a launch inside a backward node (a host op whose ``Fwd thread id`` is
  set) goes to the phase around the forward op that made the node: the last
  forward op carrying the node's ``Sequence number`` (the ops before it
  that made no node carry it too).  So the block's backward GEMMs, kernel
  B4 and the backward collectives are the block's, and the loss's backward
  is ``train.grads``';
- any other launch goes to the innermost ``train.*`` range around it on its
  thread.

What lands in no phase (``train.step``'s own time, a launch outside every
range) is ``unattributed``.  Seconds are clipped to the window as
``trace.summarize`` clips them, so the phases and ``unattributed`` sum to
its ``device_s``.  Sequence numbers count on each thread; the step's
forward runs on the one thread that opens the ranges.

No runner calls it yet: the ranges exist only under the program's tracer,
and ``kinds/train.py`` activates none, so its traced window has no
``train.*`` range and ``attribute`` would give {}.  A runner that reads
the blocks activates a ``Tracer`` around the run and hands ``attribute``
the events of a traced window (``trace.summarize_profile`` reads and
deletes them)."""

from __future__ import annotations

import re
from typing import Optional

from benchmark import readings
from benchmark import trace as btrace

PREFIX = "train."
PHASES = ("train.attn", "train.mlp", "train.grads")
NONE = "unattributed"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _window(events: list, window: str) -> Optional[tuple]:
    for e in events:
        if e.get("ph") == "X" and e.get("name") == window and e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def _host_threads(events: list) -> dict:
    """The host events of each (pid, tid), by start, an enclosing event
    before the events it encloses."""
    threads: dict = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if str(e.get("cat", "")).lower() in btrace.HOST_CATS + LAUNCH_CATS:
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    return threads


def _innermost(stack: list, kind: str):
    for _, k, value in reversed(stack):
        if k == kind:
            return value
    return None


def _launches(events: list) -> tuple:
    """(by correlation: ("direct", phase) or ("backward", sequence number),
    the phase around each forward op by its sequence number)."""
    launches, forward = {}, {}
    for evs in _host_threads(events).values():
        stack: list = []  # (end, "phase" or "node", name or sequence number)
        for e in evs:
            start = float(e["ts"])
            while stack and stack[-1][0] <= start:
                stack.pop()
            args = e.get("args") or {}
            cat = str(e.get("cat", "")).lower()
            seq = args.get("Sequence number")
            backward = cat == "cpu_op" and seq is not None and bool(args.get("Fwd thread id"))
            phase = _innermost(stack, "phase")
            if cat == "cpu_op" and seq is not None and not backward and phase is not None:
                # every op since the last node was made carries the number
                # of the next one: the last of them makes it
                forward[seq] = phase
            if cat in LAUNCH_CATS and "correlation" in args:
                node = _innermost(stack, "node")
                launches[args["correlation"]] = (
                    ("backward", node) if node is not None else ("direct", phase))
            end = start + float(e["dur"])
            if cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
                stack.append((end, "phase", e["name"]))
            elif backward:
                stack.append((end, "node", seq))
    return launches, forward


def _phase(launch: Optional[tuple], forward: dict) -> str:
    if launch is None:
        return NONE
    kind, value = launch
    phase = value if kind == "direct" else forward.get(value)
    return phase if phase in PHASES else NONE


def attribute(events: list, window: str = btrace.WINDOW) -> dict:
    """{phase: [device seconds, of which NCCL kernels'], ...} for every
    phase and ``unattributed``, over the window's device operations; {} when
    the window holds no ``train.*`` range (a program without the spans)."""
    bounds = _window(events, window)
    if bounds is None:
        return {}
    w0, w1 = bounds
    if not any(e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and str(e.get("name", "")).startswith(PREFIX)
               and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0
               for e in events):
        return {}
    launches, forward = _launches(events)
    nccl = re.compile(readings.NCCL)
    out = {name: [0.0, 0.0] for name in PHASES + (NONE,)}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if str(e.get("cat", "")).lower() not in btrace.DEVICE_CATS:
            continue
        start, end = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if end <= start:
            continue
        seconds = (end - start) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        entry = out[_phase(launches.get(corr), forward)]
        entry[0] += seconds
        if nccl.search(e.get("name", "")):
            entry[1] += seconds
    return out

