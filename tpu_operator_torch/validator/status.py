"""Workload drop-box paths: own copy of the part of
``tpu_operator/validator/status.py`` the gate writes through.  Every path
must come out identical to the reference's under the same
``TPU_VALIDATION_ROOT``, so the validator reads the port's results unchanged.
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
