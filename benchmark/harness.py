"""One run of one cell: the runner its traffic names, then the metrics the
cell reports, the check on the loaded modules, and the result line."""

from __future__ import annotations

import json
import sys

from benchmark import modcheck
from benchmark.spec import Run, Spec, kind


def execute(spec: Spec, name: str, seed: int, seconds: float, trace: bool, started: float,
            device: str = "cuda", patch: str = "", config: dict = None,
            traffic: dict = None) -> dict:
    """Run the cell ``name`` once and return its runner's outcome.
    ``config`` and ``traffic`` replace the cell's files (the tests' tiny
    sizes)."""
    workload = spec.workload(name)
    run = Run(
        workload=workload,
        config=config or spec.config(workload["config"]),
        traffic=traffic or spec.traffic(workload["traffic"]),
        limits=spec.cell(name)["limits"],
        seed=seed, seconds=seconds, trace=trace, started=started, device=device,
        patch=patch, root=spec.root,
    )
    return kind(run.traffic["kind"]).run(run)


def result_line(spec: Spec, name: str, outcome: dict, trace: bool) -> dict:
    """The result line of the contract.  With ``trace`` the metrics are the
    cell's per-layer metrics, each read by its reader (one that finds
    nothing is left out); else its end-to-end metrics, which the runner
    must all have given."""
    metrics = {}
    if trace:
        ctx = outcome["layer"]
        for m in spec.per_layer(name):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(name):
            metrics[m["name"]] = {"value": outcome["end_to_end"][m["name"]], "unit": m["unit"]}
    line = {
        "correct": bool(outcome["correct"]),
        "attempted": outcome["attempted"],
        "failed": outcome["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if outcome["device"]["kind"] != "cpu" else "cpu",
                   **outcome["device"]},
    }
    if trace and outcome.get("breakdown"):
        line["breakdown"] = outcome["breakdown"]
    line["compared"] = outcome["compared"]
    return line


def finish(spec: Spec, name: str, outcome: dict, trace: bool) -> int:
    """The last checks and the printing: no JAX in this process or in a
    rank, then each number compared on standard error and the result line
    on standard output."""
    banned = sorted(set(modcheck.banned_modules()) | set(outcome.get("banned", [])))
    if banned:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(banned)}",
              file=sys.stderr, flush=True)
        return 3
    line = result_line(spec, name, outcome, trace)
    for key, c in line["compared"].items():
        print(f"compared {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
