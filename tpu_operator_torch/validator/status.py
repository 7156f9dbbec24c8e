"""Validation status files and the workload drop-box: own copy of
``tpu_operator/validator/status.py``.  Every path and file format comes out
identical to the reference's under the same ``TPU_VALIDATION_ROOT``, so the
unchanged operator, status exporter and validator read what the port
writes, and the port reads theirs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from tpu_operator_torch import consts


def validation_dir() -> str:
    root = os.environ.get(consts.VALIDATION_ROOT_ENV)
    if root:
        return os.path.join(root, "validations")
    return consts.VALIDATION_DIR


def worker_id_path() -> str:
    """/run/tpu/worker_id: the handoff file between feature discovery
    (writer) and node-local daemons without apiserver access, e.g. the
    device plugin's Allocate env (reader)."""
    return os.path.join(os.path.dirname(validation_dir()), "worker_id")


def slice_config_path() -> str:
    """/run/tpu/slice_config.json: the applied partition layout, written by
    the slice manager and read by the device plugin's mixed strategy."""
    return os.path.join(os.path.dirname(validation_dir()), "slice_config.json")


def status_path(component: str) -> str:
    name = consts.STATUS_FILES.get(component, f"{component}-ready")
    return os.path.join(validation_dir(), name)


def write_ready(component: str, payload: Optional[dict] = None) -> str:
    path = status_path(component)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = {"component": component, "ts": time.time(), **(payload or {})}
    # tmp+replace: the ready markers gate the whole init chain — a reader
    # must never parse a torn one
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)
    return path


def is_ready(component: str) -> bool:
    return os.path.exists(status_path(component))


def read_status(component: str) -> Optional[dict]:
    try:
        with open(status_path(component)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def clear(component: str) -> None:
    try:
        os.remove(status_path(component))
    except OSError:
        pass


def cleanup_all() -> int:
    """--cleanup-all: remove every *-ready file (the validator's preStop)."""
    d = validation_dir()
    removed = 0
    try:
        names = os.listdir(d)
    except OSError:
        return 0
    for name in names:
        if name.endswith("-ready"):
            try:
                os.remove(os.path.join(d, name))
                removed += 1
            except OSError:
                pass
    return removed


def write_marker(name: str) -> str:
    """Dot-file markers for intra-chain handoff (``.libtpu-ctr-ready``);
    tmp+replace so a reader never sees a half-written timestamp."""
    path = os.path.join(validation_dir(), name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(str(time.time()))
    os.replace(tmp, path)
    return path


def marker_exists(name: str) -> bool:
    return os.path.exists(os.path.join(validation_dir(), name))


def workload_results_path(scope: str = "") -> str:
    """Node-local drop-box for the measured numbers of the last validation
    workload run on this host; ``scope`` separates rendezvous kinds."""
    root = os.path.dirname(validation_dir())
    suffix = f"-{scope}" if scope else ""
    return os.path.join(root, "workload-results", f"results{suffix}.json")


def write_workload_results(results: dict, scope: str = "") -> None:
    """Best-effort: measurement evidence must never fail a validation —
    including a non-serializable value raising TypeError."""
    try:
        path = workload_results_path(scope)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # per-process tmp name: local workers sharing one validation root
        # must not interleave writes; os.replace keeps the publish atomic
        tmp = path + f".{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), **results}, f)
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 — evidence is optional, the verdict is not
        pass


def clear_workload_results(scope: str = "") -> None:
    """Drop a scope's measured evidence (the perf component clears before
    each probe run so a failed run can never republish stale figures)."""
    try:
        os.remove(workload_results_path(scope))
    except OSError:
        pass


def read_workload_results(scope: str = "") -> Optional[dict]:
    try:
        with open(workload_results_path(scope)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def flight_record_path(scope: str = "") -> str:
    """JSONL flight record of the last validation workload run, beside the
    results drop-box.  Scoped like the results file."""
    root = os.path.dirname(validation_dir())
    suffix = f"-{scope}" if scope else ""
    return os.path.join(root, "workload-results", f"flight{suffix}.jsonl")


def read_flight_record(scope: str = "") -> list[dict]:
    """Parsed flight samples; a torn or missing record reads as fewer
    samples, never an error (evidence is best-effort)."""
    samples: list[dict] = []
    try:
        with open(flight_record_path(scope)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    samples.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        return []
    return samples


def clear_flight_record(scope: str = "") -> None:
    try:
        os.remove(flight_record_path(scope))
    except OSError:
        pass


def join_phase_segments(node_created_ts: Optional[float] = None) -> dict:
    """This node's join→validated critical-path segments from the evidence
    on disk: the status files' ``ts`` stamps and the flight record's
    compile samples.  The segments telescope — their sum is jax-ready minus
    node creation.  Absent files contribute nothing."""

    def ts(component: str) -> Optional[float]:
        st = read_status(component)
        value = st.get("ts") if st else None
        return float(value) if isinstance(value, (int, float)) else None

    libtpu, pjrt, plugin, jax_ready = (
        ts("libtpu"), ts("pjrt"), ts("plugin"), ts("jax")
    )
    phases: dict = {}
    if libtpu is not None and node_created_ts is not None:
        phases["runtime-ready"] = max(0.0, libtpu - node_created_ts)
    if pjrt is not None and libtpu is not None:
        phases["validator-scheduled"] = max(0.0, pjrt - libtpu)
    if plugin is not None and pjrt is not None:
        phases["plugin-advertised"] = max(0.0, plugin - pjrt)
    if jax_ready is not None and plugin is not None:
        tail_s = max(0.0, jax_ready - plugin)
        # compile time from the flight record: per check, the largest
        # compile_s sample (re-records must not double count), summed
        # across checks, clamped into the gate tail
        per_check: dict = {}
        for sample in read_flight_record():
            value = (sample.get("metrics") or {}).get("compile_s")
            if isinstance(value, (int, float)) and value >= 0:
                check = sample.get("check", "")
                per_check[check] = max(per_check.get(check, 0.0), float(value))
        compile_s = min(tail_s, sum(per_check.values()))
        phases["compile"] = compile_s
        phases["collective"] = max(0.0, tail_s - compile_s)
    return {k: round(v, 6) for k, v in phases.items()}


def flight_evidence(scope: str = "", tail: int = 50) -> Optional[dict]:
    """The flight record as ready-payload evidence: its path, sample count,
    the checks and span ids the samples carry, and the newest ``tail``
    samples (bounded, so a long run cannot balloon a status file)."""
    samples = read_flight_record(scope)
    if not samples:
        return None
    span_ids = sorted({s["span_id"] for s in samples if s.get("span_id")})
    return {
        "path": flight_record_path(scope),
        "samples": len(samples),
        "checks": sorted({s.get("check", "") for s in samples}),
        "span_ids": span_ids,
        "tail": samples[-tail:],
    }
