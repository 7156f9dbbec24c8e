"""Shared agent plumbing: signal-aware main loops, duration parsing (own copy
of ``tpu_operator/agents/base.py``)."""

from __future__ import annotations

import asyncio
import logging
import os
import re
import signal
import sys


def setup_logging(fmt: str | None = None) -> None:
    """The one logging entry point for every agent binary.  Structured JSON
    is opt-in: ``--log-format=json`` on the command line (agents keep their
    minimal argv surfaces, so this is scanned rather than argparsed) or
    ``TPU_OPERATOR_LOG_FORMAT=json`` injected by the DaemonSet template."""
    from tpu_operator_torch import consts
    from tpu_operator_torch.obs import logging as obs_logging

    if fmt is None:
        for arg in sys.argv[1:]:
            if arg.startswith("--log-format="):
                fmt = arg.split("=", 1)[1]
        fmt = fmt or os.environ.get(consts.LOG_FORMAT_ENV, obs_logging.FORMAT_TEXT)
    obs_logging.setup(fmt)


_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h)?$")
_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}


def parse_duration(text: str) -> float:
    """'60s' / '5m' / '1.5h' / '30' → seconds (GFD sleepInterval format)."""
    m = _DURATION_RE.match(text.strip())
    if not m:
        raise ValueError(f"invalid duration {text!r}")
    return float(m.group(1)) * _UNITS[m.group(2)]


def stop_event() -> asyncio.Event:
    """Event set on SIGTERM/SIGINT (kubelet pod shutdown)."""
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    return stop


async def run_periodic(fn, interval: float, stop: asyncio.Event, run_immediately: bool = True) -> None:
    """Call (a)sync ``fn`` every ``interval`` seconds until stop is set."""
    if run_immediately:
        result = fn()
        if asyncio.iscoroutine(result):
            await result
    while not stop.is_set():
        try:
            await asyncio.wait_for(stop.wait(), timeout=interval)
        except asyncio.TimeoutError:
            pass
        if stop.is_set():
            break
        result = fn()
        if asyncio.iscoroutine(result):
            await result
