"""Concurrent partition isolation acceptance on PyTorch/CUDA: port of
``tpu_operator/workloads/partition_acceptance.py``.

Two disjoint partitions of one host must run independent workloads at the
same time without perturbing each other.  ``concurrent_acceptance`` spawns
one real workload process per partition unit
(``python -m tpu_operator_torch.workloads.run_validation``, the burn-in with
the unit's own seed), each with the masked device set the device plugin's
Allocate would inject, held at a filesystem start barrier until every unit
is present, so simultaneous execution is a construction, not a race.  Each
unit's loss trajectory is then compared exactly against that unit's solo
run: a partition whose numerics change when its neighbour is busy has a
leaky isolation boundary.

On the card (``simulate_cpu=False``) a unit's mask is
``CUDA_VISIBLE_DEVICES``, the counterpart of the reference's
``TPU_VISIBLE_CHIPS``: CUDA's indices of its cards, or, given the device
plugin's allocation env for the unit (``allocations``), that env as the
kubelet would start the container with it (the plugin names a unit's cards
by UUID, in NVML's order, which is not CUDA's).  On the CPU (``simulate_cpu=True``, the default) a
unit runs ``TORCH_DEVICE=cpu`` with ``DIST_CPU_RANKS`` = its size gloo
ranks, the counterpart of the reference's virtual CPU devices.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

_COMMAND = [sys.executable, "-m", "tpu_operator_torch.workloads.run_validation"]


def unit_env(
    chip_indices: list[int],
    shape: str,
    *,
    seed: int,
    barrier_dir: Optional[str] = None,
    barrier_count: int = 0,
    simulate_cpu: bool = True,
    allocation: Optional[dict] = None,
) -> dict:
    """The env a workload process needs to run masked to one partition unit:
    the device plugin's Allocate mask (``allocation``'s env when given, else
    CUDA's indices ``chip_indices``), the burn-in seed and the optional
    start barrier.  ``shape`` is the reference's argument, kept for its
    callers: the port has no ``TPU_CHIPS_PER_HOST_BOUNDS``, since CUDA
    numbers the visible cards 0..n-1 whatever their shape."""
    from tpu_operator_torch.workloads import subprocess_pythonpath

    env = {
        **os.environ,
        # unit processes re-import the package via -m
        "PYTHONPATH": subprocess_pythonpath(),
        "WORKLOAD_CHECKS": "burn-in",
        "BURN_IN_SEED": str(seed),
        # the unit's true size: a leaked node-level EXPECTED_DEVICES (the
        # validator sets it for the whole host) would fail the masked
        # process's device-count gate before the burn-in ran
        "EXPECTED_DEVICES": str(len(chip_indices)),
    }
    # a leaked RESULTS_SCOPE would redirect this unit's drop-box
    env.pop("RESULTS_SCOPE", None)
    if simulate_cpu:
        env["TORCH_DEVICE"] = "cpu"
        env["DIST_CPU_RANKS"] = str(len(chip_indices))
    else:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in sorted(chip_indices))
        env.update(allocation or {})
        env["DEVICE_COUNT_GATE_BACKENDS"] = "cuda"
        # a unit on the card never runs on the CPU
        env.pop("TORCH_DEVICE", None)
        env.pop("DIST_CPU_RANKS", None)
    if barrier_dir:
        env["WORKLOAD_START_BARRIER"] = barrier_dir
        env["WORKLOAD_BARRIER_COUNT"] = str(barrier_count)
    return env


def _parse_burn_in(stdout: str) -> Optional[dict]:
    """The burn-in check record from a run_validation stdout stream: one
    parser for the solo and concurrent paths."""
    burn = None
    for line in (stdout or "").splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("check") == "burn-in":
                burn = rec
    return burn


def _tail(stream) -> str:
    if isinstance(stream, bytes):
        stream = stream.decode(errors="replace")
    return (stream or "")[-1500:]


def _run_unit(env: dict, timeout: float) -> dict:
    try:
        proc = subprocess.run(_COMMAND, env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return {
            "returncode": None,
            "timed_out": True,
            "burn_in": None,
            "stdout_tail": _tail(e.stdout),
            "stderr_tail": _tail(e.stderr),
        }
    return {
        "returncode": proc.returncode,
        "burn_in": _parse_burn_in(proc.stdout),
        "stdout_tail": proc.stdout[-1500:],
        "stderr_tail": proc.stderr[-1500:],
    }


def concurrent_acceptance(
    units: dict[str, list[int]],
    shape: str,
    steps: int = 3,
    timeout: float = 240,
    simulate_cpu: bool = True,
    allocations: Optional[dict[str, dict]] = None,
) -> dict:
    """Run every partition unit's burn-in at once (start-barrier
    synchronized) and compare each trajectory exactly against that unit's
    solo run.

    ``units``: unit name → local card indices or UUIDs (disjoint — raises
    if not); ``allocations``: unit name → the plugin's allocation env, which
    then masks the unit on the card.  Returns ``ok`` plus per-unit
    evidence."""
    allocations = allocations or {}
    names = sorted(units)
    flat: list[int] = [c for name in names for c in units[name]]
    if len(set(flat)) != len(flat):
        raise ValueError(f"partition units overlap: {units}")

    # solo runs first: each unit alone, nothing else running
    solo: dict[str, list[float]] = {}
    for i, name in enumerate(names):
        env = unit_env(units[name], shape, seed=i + 1, simulate_cpu=simulate_cpu,
                       allocation=allocations.get(name))
        env["BURN_IN_STEPS"] = str(steps)
        r = _run_unit(env, timeout)
        if r["returncode"] != 0 or not (r["burn_in"] or {}).get("ok"):
            return {"ok": False, "stage": "solo", "unit": name, **r}
        solo[name] = r["burn_in"]["losses"]

    # the concurrent run: all units at once, held at the barrier until
    # every one is present
    with tempfile.TemporaryDirectory(prefix="tpu-partition-barrier-") as bd:
        procs = {}
        t0 = time.monotonic()
        concurrent: dict[str, dict] = {}
        try:
            for i, name in enumerate(names):
                env = unit_env(
                    units[name], shape, seed=i + 1,
                    barrier_dir=bd, barrier_count=len(names),
                    simulate_cpu=simulate_cpu, allocation=allocations.get(name),
                )
                env["BURN_IN_STEPS"] = str(steps)
                procs[name] = subprocess.Popen(
                    _COMMAND, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True,
                )
            for name in names:
                try:
                    out, err = procs[name].communicate(
                        timeout=max(1.0, timeout - (time.monotonic() - t0))
                    )
                except subprocess.TimeoutExpired:
                    # a hung unit is evidence, not a traceback
                    procs[name].kill()
                    out, err = procs[name].communicate()
                    concurrent[name] = {
                        "returncode": procs[name].returncode,
                        "timed_out": True,
                        "burn_in": None,
                        "stderr_tail": (err or "")[-1500:],
                    }
                    continue
                concurrent[name] = {
                    "returncode": procs[name].returncode,
                    "burn_in": _parse_burn_in(out),
                    "stderr_tail": (err or "")[-1500:],
                }
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()

    unit_results = {}
    ok = True
    for name in names:
        c = concurrent[name]
        burn = c["burn_in"] or {}
        losses = burn.get("losses")
        matches = losses == solo[name]
        unit_ok = c["returncode"] == 0 and bool(burn.get("ok")) and matches
        ok = ok and unit_ok
        unit_results[name] = {
            "ok": unit_ok,
            "chips": units[name],
            "losses": losses,
            "solo_losses": solo[name],
            "matches_solo": matches,
            "devices": burn.get("devices"),
        }
    # disjoint partitions run different seeds, so identical trajectories
    # would mean one unit's computation leaked into the other (or the
    # masking collapsed both onto the same cards)
    trajectories = [tuple(u["losses"] or ()) for u in unit_results.values()]
    independent = len(set(trajectories)) == len(trajectories)
    return {
        "ok": ok and independent,
        "units": unit_results,
        "independent_trajectories": independent,
        "concurrent": True,
    }
