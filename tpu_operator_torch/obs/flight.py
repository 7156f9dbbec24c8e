"""Per-step workload flight recorder + node telemetry push client: own copy
of the part of ``tpu_operator/obs/flight.py`` the gate uses.

- ``record(check, phase, step=..., **metrics)`` appends one sample (wall
  ``ts``, ``run_id``, ``check``, ``phase``, optional ``step``, the metric map,
  and the enclosing span's ids) to a bounded ring.
- Samples persist as the same append-only JSONL **flight record** beside the
  results drop-box (``validator.status.flight_record_path``).
- Mapped counters push to the node metrics agent (``TPU_METRICS_PUSH_URL``)
  from a background thread, stdlib ``urllib`` only; ``record()`` never
  touches the network.

The module-level ``record()`` is a no-op unless a recorder was activated
with ``activate(recorder)``.  A rank process of the local multi-rank
launcher records into an in-memory recorder; its samples come back with the
rank's result and are ``replay()``\\ ed into the parent's recorder, so a
multi-rank check leaves the same flight trail as an in-process one.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from contextvars import ContextVar
from typing import Iterator, Optional

from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.obs import trace

PUSH_ENV = "TPU_METRICS_PUSH_URL"

MAX_SAMPLES = 4096  # ring bound: telemetry, not a database
PUSH_INTERVAL_S = 1.0  # at most one POST per interval
_FLUSH_EVERY = 32   # samples between best-effort JSONL appends
MAX_STEP_WINDOW = 64

# sample metric key → canonical workload counter (agents.metrics_agent
# WORKLOAD_COUNTERS): the keys the ported checks emit; a later slice adds
# the keys of the checks it ports
COUNTER_KEYS = {
    "step_s": "tpu_workload_step_duration_seconds",
    "compile_s": "tpu_workload_compile_seconds",
    "gbps": "tpu_workload_achieved_gbps",
    "overhead_dominated": "tpu_workload_overhead_dominated",
    # compile-artifact cache counters (workloads/compile_cache.py
    # ArtifactStore.record_flight_sample): the warm-pool evidence
    "cache_hits": "tpu_workload_compile_cache_hits_total",
    "cache_misses": "tpu_workload_compile_cache_misses_total",
    "cache_bytes": "tpu_workload_compile_cache_bytes_total",
    # sustained-serving telemetry (workloads/serving.py
    # ServingEngine.telemetry): per-step rolling rollups, every key
    # serve_-prefixed (this map is global across workloads)
    "serve_tokens_per_sec": "tpu_workload_serving_tokens_per_sec",
    "serve_ttft_p99_s": "tpu_workload_serving_ttft_p99_seconds",
    "serve_tpot_p99_s": "tpu_workload_serving_tpot_p99_seconds",
    "serve_queue_depth": "tpu_workload_serving_queue_depth",
    "serve_batch_size": "tpu_workload_serving_batch_size",
    "serve_kv_blocks_free": "tpu_workload_serving_kv_blocks_free",
    "serve_requests_completed": "tpu_workload_serving_requests_completed_total",
    "serve_requests_rejected": "tpu_workload_serving_requests_rejected_total",
    "serve_decoded_tokens": "tpu_workload_serving_decoded_tokens_total",
    # chip-time accounting evidence (workloads/checkpoint.py training loop
    # and restore path); acct_* are cumulative seconds per process
    "checkpoint_s": "tpu_workload_checkpoint_seconds",
    "restore_s": "tpu_workload_restore_seconds",
    "acct_useful_s": "tpu_workload_useful_seconds_total",
    "acct_wasted_s": "tpu_workload_wasted_seconds_total",
    "replayed_steps": "tpu_workload_replayed_steps_total",
    "lost_steps": "tpu_workload_lost_steps_total",
}

# result keys of the ported checks worth a summary sample (record_result),
# normalized onto the sample metric vocabulary as in the reference
_RESULT_KEYS = {
    "algbw_gbps": "gbps",
    "busbw_gbps": "busbw_gbps",
    "time_s": "time_s",
    "duration_s": "duration_s",
    "max_error": "max_error",
    "overhead_dominated": "overhead_dominated",
}


class FlightRecorder:
    """Bounded sample ring with JSONL persistence and throttled push."""

    def __init__(self, path: str = "", push_url: str = ""):
        self.path = path
        self.push_url = push_url
        env_ctx = trace.TraceContext.from_env()
        self.trace_id = env_ctx.trace_id if env_ctx is not None else ""
        self.run_id = f"{os.getpid()}-{int(time.time())}"
        self.host = os.environ.get("NODE_NAME", "") or socket.gethostname()
        self.samples: list[dict] = []
        self.dropped = 0
        self._unflushed = 0
        self._persisted = 0
        self._pending: dict[str, dict] = {}
        self._pending_steps: dict[str, list] = {}
        self._step_seq_hwm: dict[str, int] = {}
        self._step_counts: dict[str, int] = {}
        self._push_lock = threading.Lock()
        self._push_wake = threading.Event()
        self._push_thread: Optional[threading.Thread] = None
        self._closed = False

    # ------------------------------------------------------------------
    def _stamp(self, sample: dict) -> None:
        sp = trace.current_span()
        if sp is not None:
            sample["span_id"] = sp.span_id
            if sp.reconcile_id:
                sample["reconcile_id"] = sp.reconcile_id
        tid = (sp.trace_id if sp is not None else "") or self.trace_id
        if tid:
            sample["trace_id"] = tid

    def record(
        self,
        check: str,
        phase: str = "step",
        step: Optional[int] = None,
        **metrics,
    ) -> dict:
        sample: dict = {
            "ts": round(time.time(), 6),
            "run_id": self.run_id,
            "check": check,
            "phase": phase,
        }
        if step is not None:
            sample["step"] = step
        self._stamp(sample)
        # non-finite floats (a NaN loss) would corrupt the JSONL record and
        # the push payload; record their absence, not their poison
        sample["metrics"] = {
            k: v
            for k, v in metrics.items()
            if v is not None
            and not (isinstance(v, float) and not math.isfinite(v))
        }
        self._append(sample)
        self._queue_push(check, sample["metrics"])
        return sample

    def _append(self, sample: dict) -> None:
        if len(self.samples) >= MAX_SAMPLES:
            self.samples.pop(0)
            self.dropped += 1
            if self._persisted > 0:
                self._persisted -= 1
        self.samples.append(sample)
        self._unflushed += 1
        if self.path and self._unflushed >= _FLUSH_EVERY:
            self.flush()

    def record_step(
        self,
        check: str,
        step_seq: int,
        wall_s: float,
        phases: Optional[dict] = None,
    ) -> Optional[dict]:
        """One step-profile window with a per-check MONOTONIC ``step_seq``
        (a replay or out-of-order call is dropped at the source)."""
        try:
            seq = int(step_seq)
        except (TypeError, ValueError):
            return None
        if not isinstance(wall_s, (int, float)) or isinstance(wall_s, bool) \
                or not math.isfinite(float(wall_s)) or float(wall_s) < 0:
            return None
        hwm = self._step_seq_hwm.get(check)
        if hwm is not None and seq <= hwm:
            return None
        self._step_seq_hwm[check] = seq
        entry = {
            "step_seq": seq,
            "host": self.host,
            "wall_s": round(float(wall_s), 6),
            "phases": {
                name: round(float(v), 6)
                for name, v in (phases or {}).items()
                if name in obs_profile.STEP_PHASES
                and isinstance(v, (int, float)) and not isinstance(v, bool)
                and math.isfinite(float(v)) and float(v) >= 0.0
            },
        }
        sample: dict = {
            "ts": round(time.time(), 6),
            "run_id": self.run_id,
            "check": check,
            "phase": "step-window",
            "step": seq,
            **entry,
        }
        self._stamp(sample)
        self._append(sample)
        if self.push_url and not self._closed:
            with self._push_lock:
                queue = self._pending_steps.setdefault(check, [])
                queue.append(entry)
                del queue[:-MAX_STEP_WINDOW]
            self._wake_pusher()
        return sample

    def record_result(self, check: str, result: dict) -> Optional[dict]:
        """One summary sample from a check's result dict."""
        if not isinstance(result, dict):
            return None
        metrics = {}
        for key, name in _RESULT_KEYS.items():
            value = result.get(key)
            if isinstance(value, bool):
                metrics[name] = float(value)
            elif isinstance(value, (int, float)):
                metrics[name] = value
        if not result.get("ok", True):
            metrics["failed"] = 1.0
        return self.record(check, phase="result", **metrics)

    def replay(self, samples: list[dict]) -> None:
        """Re-record samples taken by another process (a rank of the local
        launcher) under this recorder's run id and the current span; their
        ``ts`` becomes the replay time."""
        for s in samples:
            if s.get("phase") == "step-window":
                self.record_step(
                    s["check"], s["step_seq"], s["wall_s"], s.get("phases")
                )
            else:
                self.record(
                    s["check"], s.get("phase", "step"), s.get("step"),
                    **s.get("metrics", {}),
                )

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Append the not-yet-persisted samples to the JSONL record
        (append-only: local writers sharing one validation root accumulate
        instead of erasing each other; the validator clears it per run)."""
        self._unflushed = 0
        if not self.path:
            return
        try:
            new = self.samples[self._persisted:]
            if not new:
                return
            lines = []
            for sample in new:
                try:
                    lines.append(json.dumps(sample) + "\n")
                except (TypeError, ValueError):
                    continue
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write("".join(lines))
            self._persisted = len(self.samples)
        except Exception as e:  # noqa: BLE001 — telemetry must never fail the workload
            logging.getLogger("tpu_operator_torch.obs.flight").debug(
                "flight flush failed: %s", e
            )

    def close(self) -> None:
        self.flush()
        self._closed = True
        thread = self._push_thread
        if thread is not None:
            self._push_wake.set()
            # bounded: a blackholed agent must not hold the workload's exit
            thread.join(timeout=3.0)

    # ------------------------------------------------------------------
    def _wake_pusher(self) -> None:
        if self._push_thread is None:
            self._push_thread = threading.Thread(
                target=self._push_loop, name="flight-push", daemon=True
            )
            self._push_thread.start()
        self._push_wake.set()

    def _queue_push(self, check: str, metrics: dict) -> None:
        if not self.push_url or self._closed:
            return
        with self._push_lock:
            counters = self._pending.setdefault(check, {})
            for key, counter in COUNTER_KEYS.items():
                value = metrics.get(key)
                if isinstance(value, (bool, int, float)):
                    counters[counter] = float(value)
            self._step_counts[check] = self._step_counts.get(check, 0) + 1
            counters["tpu_workload_steps_total"] = float(self._step_counts[check])
        self._wake_pusher()

    def _take_pending(self) -> Optional[dict]:
        with self._push_lock:
            if not self._pending and not any(self._pending_steps.values()):
                return None
            workloads = {
                check: {"counters": dict(counters)}
                for check, counters in self._pending.items()
            }
            for check, steps in self._pending_steps.items():
                if steps:
                    entry = workloads.setdefault(check, {"counters": {}})
                    entry["steps"] = list(steps)
            self._pending.clear()
            self._pending_steps.clear()
        return workloads

    def _requeue(self, workloads: dict) -> None:
        """Put a failed push window back; values recorded since the take
        win, step windows merge back by step_seq."""
        with self._push_lock:
            for check, entry in workloads.items():
                live = self._pending.setdefault(check, {})
                merged = {**entry.get("counters", {}), **live}
                live.clear()
                live.update(merged)
                steps = entry.get("steps")
                if steps:
                    queue = self._pending_steps.setdefault(check, [])
                    seen = {s["step_seq"] for s in queue}
                    queue[:0] = [s for s in steps if s["step_seq"] not in seen]
                    queue.sort(key=lambda s: s["step_seq"])
                    del queue[:-MAX_STEP_WINDOW]

    def _push_loop(self) -> None:
        """Drain the pending counters at most once per ``PUSH_INTERVAL_S``,
        with exponential backoff on failures."""
        failures = 0
        while True:
            self._push_wake.wait(timeout=PUSH_INTERVAL_S)
            self._push_wake.clear()
            if failures:
                time.sleep(min(30.0, 2.0 ** failures) if not self._closed else 0)
            workloads = self._take_pending()
            if workloads is None:
                if self._closed:
                    return
                continue
            payload = {
                "source": "workload",
                "run_id": self.run_id,
                "workloads": workloads,
            }
            if self.trace_id:
                payload["trace_id"] = self.trace_id
            req = urllib.request.Request(
                self.push_url,
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=1.0):
                    pass
                failures = 0
            except (urllib.error.URLError, OSError, ValueError):
                failures += 1
                self._requeue(workloads)
            if self._closed and (
                failures
                or not (self._pending or any(self._pending_steps.values()))
            ):
                return
            if not self._closed:
                time.sleep(PUSH_INTERVAL_S)


# ---------------------------------------------------------------------------
# ambient recorder

_current: ContextVar[Optional[FlightRecorder]] = ContextVar(
    "tpu_operator_torch_flight", default=None
)


def recorder_for(path: str) -> FlightRecorder:
    """Recorder persisting at ``path`` (the drop-box flight record), pushing
    to TPU_METRICS_PUSH_URL when set."""
    return FlightRecorder(path=path, push_url=os.environ.get(PUSH_ENV, ""))


def active() -> Optional[FlightRecorder]:
    return _current.get()


@contextlib.contextmanager
def activate(recorder: FlightRecorder) -> Iterator[FlightRecorder]:
    """Make ``recorder`` ambient for the current context; closes (final
    flush + push) on exit."""
    token = _current.set(recorder)
    try:
        yield recorder
    finally:
        _current.reset(token)
        recorder.close()


def record(
    check: str, phase: str = "step", step: Optional[int] = None, **metrics
) -> None:
    """Sample on the AMBIENT recorder; no-op when none is active."""
    recorder = active()
    if recorder is not None:
        recorder.record(check, phase=phase, step=step, **metrics)


def record_result(check: str, result: dict) -> None:
    recorder = active()
    if recorder is not None:
        recorder.record_result(check, result)


def record_step(
    check: str, step_seq: int, wall_s: float, phases: Optional[dict] = None
) -> None:
    recorder = active()
    if recorder is not None:
        recorder.record_step(check, step_seq, wall_s, phases=phases)


def replay(samples: list[dict]) -> None:
    recorder = active()
    if recorder is not None:
        recorder.replay(samples)


def push_join_phases(
    node: str,
    phases: dict,
    trace_id: str = "",
    url: str = "",
    timeout: float = 2.0,
) -> bool:
    """One-shot POST of a node's join→validated phase segments to the
    metrics agent (``TPU_METRICS_PUSH_URL``), which forwards them to the
    operator's fleet ingest as ``join_phase_seconds{node,phase}`` samples.
    Blocking: the validator calls it in an executor after jax-ready is
    written.  Best-effort: returns False instead of raising."""
    url = url or os.environ.get(PUSH_ENV, "")
    clean = {
        str(k): float(v)
        for k, v in (phases or {}).items()
        if isinstance(v, (int, float))
        and not isinstance(v, bool)
        and math.isfinite(float(v))
        and float(v) >= 0.0
    }
    if not url or not node or not clean:
        return False
    body: dict = {"source": "workload", "node": node, "join_phases": clean}
    if trace_id:
        body["trace_id"] = trace_id
    req = urllib.request.Request(
        url,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout):
            return True
    except (urllib.error.URLError, OSError, ValueError):
        return False
