"""The bounded per-step phase vocabulary and the workload side of step-phase
attribution: own copy of the constants, ``clean_steps``, ``StepTimer`` and
``FileStepBarrier`` in ``tpu_operator/obs/profile.py`` (the only phase
labels a step window may carry; the operator's profile plane pins
membership on the same names)."""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Iterator, Optional

PHASE_COMPILE = "compile"
PHASE_HOST_INPUT = "host-input"
PHASE_COMPUTE = "compute"
PHASE_COLLECTIVE_WAIT = "collective-wait"

STEP_PHASES = (
    PHASE_COMPILE,
    PHASE_HOST_INPUT,
    PHASE_COMPUTE,
    PHASE_COLLECTIVE_WAIT,
)

# environment contract for the file step barrier (multi-host training pods
# sharing a filesystem)
BARRIER_DIR_ENV = "TPU_STEP_BARRIER_DIR"
BARRIER_WORLD_ENV = "TPU_STEP_BARRIER_WORLD"
BARRIER_RANK_ENV = "TPU_STEP_BARRIER_RANK"
BARRIER_TIMEOUT_ENV = "TPU_STEP_BARRIER_TIMEOUT_S"

# barrier markers each rank keeps behind its own head: the catch-up
# budget for a member restored from a checkpoint while its peers
# free-ran (markers are one tiny file each, GC'd as the rank advances)
REPLAY_WINDOW_STEPS = 8192

# step windows per check per push (the metrics agent's cap)
MAX_STEPS_PER_PUSH = 128


def _finite(value) -> Optional[float]:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    v = float(value)
    if not math.isfinite(v) or v < 0.0:
        return None
    return v


def clean_steps(steps, limit: int = MAX_STEPS_PER_PUSH) -> list[dict]:
    """Validate/normalize a pushed step-window list onto the canonical
    entry shape ``{step_seq, host, wall_s, phases}`` — the shared gate the
    agent hop and the fleet ingest both apply, so a malformed or
    vocabulary-busting entry is dropped at the first hop it touches."""
    out: list[dict] = []
    if not isinstance(steps, (list, tuple)):
        return out
    for entry in steps:
        if len(out) >= limit:
            break
        if not isinstance(entry, dict):
            continue
        try:
            seq = int(entry.get("step_seq"))
        except (TypeError, ValueError):
            continue
        wall = _finite(entry.get("wall_s"))
        if seq < 0 or wall is None:
            continue
        host = str(entry.get("host") or "")[:64]
        phases = entry.get("phases") or {}
        clean_phases: dict[str, float] = {}
        if isinstance(phases, dict):
            for name in STEP_PHASES:
                v = _finite(phases.get(name))
                if v is not None:
                    clean_phases[name] = round(v, 6)
        out.append({
            "step_seq": seq,
            "host": host,
            "wall_s": round(wall, 6),
            "phases": clean_phases,
        })
    return out


class StepTimer:
    """Per-step phase accumulator for workload step loops.

    ``with timer.phase(PHASE_COMPUTE): ...`` adds the block's wall time to
    the phase's span; ``spans()`` yields the bounded phase→seconds map a
    ``flight.record_step`` window carries.  Phase names are closed over
    ``STEP_PHASES`` — an unknown name raises immediately (at development
    time, in the loop author's face) rather than minting unbounded label
    values three hops downstream."""

    def __init__(self):
        self._spans: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if name not in STEP_PHASES:
            raise ValueError(
                f"unknown step phase {name!r} (bounded vocabulary: {STEP_PHASES})"
            )
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans[name] = (
                self._spans.get(name, 0.0) + (time.perf_counter() - t0)
            )

    def add(self, name: str, seconds: float) -> None:
        """Credit already-measured seconds to a phase (loops that time a
        region themselves, e.g. a barrier wait returning its duration)."""
        if name not in STEP_PHASES:
            raise ValueError(
                f"unknown step phase {name!r} (bounded vocabulary: {STEP_PHASES})"
            )
        v = _finite(seconds)
        if v is not None:
            self._spans[name] = self._spans.get(name, 0.0) + v

    def spans(self) -> dict:
        return dict(self._spans)

    def reset(self) -> None:
        self._spans.clear()


class FileStepBarrier:
    """Filesystem step barrier for multi-host training loops.

    Emulates the per-step ICI collective sync on hosts that share a
    filesystem (the straggler soak, CPU tests): each member writes a
    ``step-<n>.<rank>`` marker then polls until every live rank's marker
    exists; :meth:`wait` returns the seconds spent blocked — which IS the
    step's collective-wait phase.  A member that exits cleanly mid-run (a
    migrating checkpoint handler) calls :meth:`leave` so peers stop
    waiting on it; a restored process re-joins by constructing a fresh
    barrier (the ctor clears its own leave marker).  A dead peer that
    never said goodbye costs at most ``timeout_s`` per step — the barrier
    degrades to free-running, it never wedges the loop."""

    def __init__(
        self,
        root: str,
        world: int,
        rank: int,
        poll_s: float = 0.002,
        timeout_s: float = 20.0,
    ):
        self.root = root
        self.world = world
        self.rank = rank
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        os.makedirs(self.root, exist_ok=True)
        # re-join: a restored member withdraws its goodbye
        with contextlib.suppress(OSError):
            os.remove(self._leave_path(rank))

    @classmethod
    def from_env(cls, env=None) -> Optional["FileStepBarrier"]:
        env = os.environ if env is None else env
        root = env.get(BARRIER_DIR_ENV, "")
        if not root:
            return None
        try:
            world = int(env.get(BARRIER_WORLD_ENV, "0"))
            rank = int(env.get(BARRIER_RANK_ENV, "-1"))
            timeout_s = float(env.get(BARRIER_TIMEOUT_ENV, "20") or 20)
        except (TypeError, ValueError):
            return None
        if world < 2 or not 0 <= rank < world:
            return None
        return cls(root, world, rank, timeout_s=timeout_s)

    def _marker(self, step: int, rank: int) -> str:
        return os.path.join(self.root, f"step-{step:08d}.{rank}")

    def _leave_path(self, rank: int) -> str:
        return os.path.join(self.root, f"leave.{rank}")

    def _publish(self, path: str) -> None:
        """tmp+replace even for a marker: peers read the arrival stamp,
        and a torn file still satisfies os.path.exists."""
        tmp = f"{path}.tmp.{self.rank}"
        with open(tmp, "w") as f:
            f.write(str(round(time.time(), 6)))
        os.replace(tmp, path)

    def wait(self, step: int) -> float:
        """Arrive at ``step``'s barrier; block until every live rank has
        arrived (or ``timeout_s``); return the seconds spent waiting."""
        t0 = time.perf_counter()
        try:
            self._publish(self._marker(step, self.rank))
        except OSError:
            return 0.0  # barrier storage gone: free-run, don't crash
        deadline = t0 + self.timeout_s
        while True:
            arrived = 0
            for r in range(self.world):
                if (os.path.exists(self._marker(step, r))
                        or os.path.exists(self._leave_path(r))):
                    arrived += 1
            if arrived >= self.world or time.perf_counter() >= deadline:
                break
            time.sleep(self.poll_s)
        # best-effort GC of my stale markers, keeping a REPLAY WINDOW of
        # recent steps: a member restored from a checkpoint behind its
        # peers must find their already-published markers and catch up at
        # full speed instead of paying timeout_s per replayed step.  The
        # window must exceed the furthest a free-running survivor can
        # drift during one migration (leave -> restore), else the
        # replayer times out per step and never closes the gap.
        with contextlib.suppress(OSError):
            os.remove(self._marker(step - REPLAY_WINDOW_STEPS, self.rank))
        return time.perf_counter() - t0

    def leave(self) -> None:
        """Say goodbye: peers count this rank as arrived from now on."""
        with contextlib.suppress(OSError):
            self._publish(self._leave_path(self.rank))
