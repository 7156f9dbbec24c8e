"""Every process a run starts has ended before the run does.

A four-card cell starts its ranks through ``multiprocessing``'s spawn
context, which also starts that module's resource tracker: a process that
outlives the ranks and ends only once every holder of its pipe has closed
it, a moment after the run's own exit.  ``adopt()`` makes this process the
reaper of its descendants (Linux's child subreaper), so that a process
whose parent ended comes back to it; ``stop_all()`` closes the tracker's
pipe and waits for it, then ends and waits for whatever is left."""

from __future__ import annotations

import ctypes
import os
import signal
import sys
import time

PR_SET_CHILD_SUBREAPER = 36


def adopt() -> None:
    """Become the reaper of this process's orphaned descendants (nothing
    where ``prctl`` is missing)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def children(pid: int = None) -> list:
    """The live children of ``pid`` (this process by default), from /proc."""
    pid = os.getpid() if pid is None else pid
    out = []
    try:
        tasks = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for task in tasks:
        try:
            with open(f"/proc/{pid}/task/{task}/children") as f:
                out += [int(c) for c in f.read().split()]
        except (OSError, ValueError):
            pass
    return sorted(set(out))


def _reap() -> None:
    """Collect every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _stop_tracker() -> None:
    """Close ``multiprocessing``'s resource tracker's pipe and wait for it
    to end, where this process started one."""
    tracker = sys.modules.get("multiprocessing.resource_tracker")
    stop = getattr(getattr(tracker, "_resource_tracker", None), "_stop", None)
    if stop is not None:
        try:
            stop()
        except (OSError, ChildProcessError):
            pass


def stop_all(grace_s: float = 10.0) -> list:
    """Stop every descendant and wait until each has ended: the tracker by
    its pipe, the rest by SIGTERM and, ``grace_s`` later, SIGKILL; a
    grandchild that its ended parent leaves behind comes back here and is
    stopped in turn.  Returns the pids that had to be signalled."""
    _stop_tracker()
    termed = {}
    deadline = time.monotonic() + 3 * grace_s
    while time.monotonic() < deadline:
        _reap()
        left = children()
        if not left:
            break
        now = time.monotonic()
        for pid in left:
            if pid not in termed:
                termed[pid], sig = now, signal.SIGTERM
            elif now - termed[pid] > grace_s:
                sig = signal.SIGKILL
            else:
                continue
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        time.sleep(0.05)
    return list(termed)
