"""Runner of the readiness-gate cells: a closed loop of one node re-joining.
Each pass is a fresh process of the gate's pod entry, ``python -m
tpu_operator_torch.workloads.run_validation``, started through
``benchmark/gate_child.py`` (which runs it in that process and keeps its
outputs), with the environment the node validator gives the gate pod
(``validator/components.py``'s ``_workload_pod``): the configuration's
checks, the card count it expects, the allreduce floor, and a validation
root of its own, under TMPDIR, for its drop-box, its flight record and
what the pass keeps for the harness.

Set-up runs the warm passes (the first in a checkout builds kernel B1's
library).  The window runs passes back to back while ``--seconds`` last; a
pass started inside runs to its end.  With ``--trace 1`` one more pass runs
under the profiler, for the card's busy time.

Once the window has closed, every pass is judged: its exit code, its JSON
lines and its drop-box as the entry hands them out, and its outputs
against the benchmark's own: each sum of kernel B1 against the float32 sum
of the entry's inputs, rebuilt here (``vector_add_inputs``), and each
buffer of the allreduce check against all ones.  The inputs are the
entry's own, so ``--seed`` does not reach them."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from benchmark import compare
from benchmark import trace as btrace
from benchmark.gate_child import CAPTURE
from benchmark.nvml_memory import MemoryPeak
from benchmark.spec import Run

PASS_TIMEOUT_S = 120.0
# what a pass must not inherit: other checks, a CPU run, pushes to a network
DROPPED_ENV = ("WORKLOAD_CHECKS", "RESULTS_SCOPE", "TORCH_DEVICE", "DIST_CPU_RANKS",
               "WORKLOAD_BUDGET_S", "WORKLOAD_START_BARRIER", "TPU_METRICS_PUSH_URL",
               "TPU_FLEET_CACHE_URL", "TPU_TRACEPARENT", "ALLREDUCE_SIZE_MB")


def checks_of(config: dict, chips: int) -> str:
    return config["checks_one_card"] if chips == 1 else config["checks_several_cards"]


def allreduce_floor(config: dict, chips: int) -> float:
    """The validator's armed allreduce floor: none on one card."""
    if chips == 1:
        return 0.0
    return round(config["nvlink_gbps"] / 2 * chips * config["allreduce_gate_fraction"], 1)


def pass_env(r: Run, root: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in DROPPED_ENV}
    path = env.get("PYTHONPATH", "")
    env.update(
        WORKLOAD_CHECKS=checks_of(r.config, r.chips),
        EXPECTED_DEVICES=str(r.chips),
        ALLREDUCE_MIN_GBPS=str(allreduce_floor(r.config, r.chips)),
        RING_MIN_GBPS="0.0",
        TPU_VALIDATION_ROOT=root,
        PYTHONPATH=r.root + (os.pathsep + path if path else ""),
    )
    if r.device == "cpu":
        env["TORCH_DEVICE"] = "cpu"
    return env


def run_pass(r: Run, base: str, label: str, argv: list) -> dict:
    """One pass: its wall from spawn to exit, exit code, JSON lines by
    check, drop-box, the seconds of its checks by their own clock, and the
    directory of what it kept for the harness."""
    root = os.path.join(base, label)
    os.makedirs(root)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, env=pass_env(r, root), cwd=r.root, capture_output=True,
                              text=True, timeout=PASS_TIMEOUT_S)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = None, e.stdout or "", f"timed out after {PASS_TIMEOUT_S} s"
        out = out.decode() if isinstance(out, bytes) else out
    wall = time.monotonic() - t0
    lines = {}
    for text in out.splitlines():
        try:
            line = json.loads(text)
        except json.JSONDecodeError:
            continue
        if isinstance(line, dict) and "check" in line:
            lines[line["check"]] = line
    try:
        with open(os.path.join(root, "workload-results", "results.json")) as f:
            dropbox = json.load(f)
    except (OSError, json.JSONDecodeError):
        dropbox = None
    checks_s = sum(float(v.get("duration_s", 0.0)) for v in lines.values())
    if rc != 0:
        print(f"benchmark: gate pass {label} exit {rc}: {err[-2000:]}", file=sys.stderr)
    return {"wall_s": wall, "rc": rc, "lines": lines, "dropbox": dropbox, "checks_s": checks_s,
            "kept": os.path.join(root, CAPTURE)}


def vector_add_inputs(config: dict) -> tuple:
    """The entry's vector-add inputs as ``collectives.vector_add`` draws
    them, a copy kept here: ``default_rng(seed)`` standard normals in
    float32, x then y, of (max(8, n // 512), 512)."""
    cols = 512
    rows = max(8, config["vector_add_n"] // cols)
    rng = np.random.default_rng(config["vector_add_seed"])
    x = rng.standard_normal((rows, cols), dtype=np.float32)
    y = rng.standard_normal((rows, cols), dtype=np.float32)
    return x, y


def _load(path: str, name: str):
    try:
        if name.endswith(".npy"):
            return np.load(os.path.join(path, name))
        with open(os.path.join(path, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def judge(p: dict, r: Run, expected: np.ndarray) -> dict:
    """One pass, judged: ``sound`` (exit 0; the card count as expected;
    each check ok at its size and in the drop-box; its outputs kept),
    ``vector_add`` and ``allreduce`` (the largest gap of its outputs from
    the benchmark's own sum and from all ones; None when it kept none) and
    ``banned`` (the JAX modules it loaded)."""
    lines, cfg = p["lines"], r.config
    devices = lines.get("devices", {})
    va, ar = lines.get("vector-add", {}), lines.get("allreduce", {})
    box = (p["dropbox"] or {}).get("checks", {})
    expected_checks = checks_of(cfg, r.chips).split(",")
    sums = _load(p["kept"], "vector_add.npy")
    buffers = _load(p["kept"], "allreduce.json") or []
    banned = _load(p["kept"], "modules.json")
    numel = cfg["allreduce_mb"] * (1 << 20) // 2 // r.chips
    results = [b for b in buffers if not b["input"]]
    vector_add = None
    if sums is not None and sums.shape[1:] == expected.shape:
        vector_add = float(np.abs(sums.astype(np.float64) - expected).max())
    allreduce = None
    if len(results) >= cfg["allreduce_best_of"] and all(b["numel"] == numel for b in buffers):
        allreduce = max(max(abs(b["min"] - 1.0), abs(b["max"] - 1.0)) for b in buffers)
    sound = (p["rc"] == 0 and banned is not None
             and devices.get("ok") is True and devices.get("visible") == r.chips
             and all(lines.get(c, {}).get("ok") is True for c in expected_checks)
             and all(box.get(c, {}).get("ok") is True for c in expected_checks)
             and va.get("n") == cfg["vector_add_n"]
             and abs(float(ar.get("size_mb", 0.0)) - cfg["allreduce_mb"] * 1.048576) < 1e-6
             and ar.get("devices") == r.chips)
    return {"sound": sound, "vector_add": vector_add, "allreduce": allreduce,
            "banned": banned or []}


def run(r: Run) -> dict:
    argv = [sys.executable, "-m", "benchmark.gate_child"]
    if r.patch:
        argv += ["--patch", r.patch]
    base = tempfile.mkdtemp(prefix="benchmark-gate-")
    try:
        with MemoryPeak(0) as memory:
            warm = [run_pass(r, base, f"warm{i}", argv) for i in range(r.traffic["warm_passes"])]
            setup_s = time.monotonic() - r.started
            passes = []
            t0 = time.monotonic()
            while time.monotonic() - t0 < r.seconds:
                passes.append(run_pass(r, base, f"pass{len(passes)}", argv))
        summary, traced = None, []
        if r.trace:
            out = os.path.join(base, "profile.json")
            traced = [run_pass(r, base, "traced", argv + ["--profile", out])]
            with open(out) as f:
                summary = json.load(f)
        # every pass's outputs are judged, the warm and the traced with the window's
        x, y = vector_add_inputs(r.config)
        expected = (x + y).astype(np.float64)
        judged = [judge(p, r, expected) for p in warm + passes + traced]
    finally:
        shutil.rmtree(base, ignore_errors=True)

    failed = sum(1 for j in judged if not j["sound"])
    va = [j["vector_add"] for j in judged]
    ar = [j["allreduce"] for j in judged]
    numbers = {
        "failed_passes": failed,
        "vector_add_max_error": max(va) if None not in va else None,
        "allreduce_max_error": max(ar) if None not in ar else None,
    }
    correct, compared = compare.verdict(numbers, r.limits)
    device = {"kind": _card_name(r), "count": r.chips, "memory_peak_bytes": memory.peak}
    if summary is not None:
        device["busy_s"] = summary.get("busy_s", 0.0)
        device["window_s"] = summary.get("window_s", 0.0)
    return {
        "end_to_end": {
            "setup_s": setup_s,
            "gate_s": sum(p["wall_s"] for p in passes) / len(passes),
        },
        "layer": {"passes": passes, "trace": summary},
        "attempted": len(judged),
        "failed": failed,
        "correct": correct and len(passes) > 0,
        "compared": compared,
        "device": device,
        "breakdown": btrace.breakdown([summary]) if summary else None,
        "banned": sorted({name for j in judged for name in j["banned"]}),
    }


def _card_name(r: Run) -> str:
    """The card's name as CUDA gives it, asked once the passes are over (a
    context made earlier would sit on the card beside them)."""
    if r.device != "cuda":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)
