"""``python -m benchmark.calibrate --workload <cell> --seeds N --faults M``:
the readings that a cell's limits are set from, taken on the card at the
cell's own size (never by a benchmark run).

Training cells, in one process a card: the program's numbers on N seeds
(set-up and the checked steps as a run makes them, then the reference);
on the first M seeds the control, the reference in TF32 put in the
program's place, the fault of half the batch left out, planted in the
reference, and the reference in float64, a second witness; on several
cards the fault of the exchange between cards left out, planted in the
program.  A state left unchanged reads 1 by the
measure and needs no run.  ``--control-only``: the control alone against
the reference on all N seeds, on one card (the reference of a cell on
several cards runs at the global shapes on one).

The readiness gate: M runs each of the control (``faults.gate_bf16``) and
the faults of ``faults.py``, each a warm pass and one in the window.

One JSON line a reading on standard output."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import compare, faults
from benchmark.kinds import train
from benchmark.reference import layer as reference
from benchmark.spec import Spec

FIRST_SEED = 1_000_003


def _leaves(program: dict, ref: dict) -> dict:
    """Each leaf's gaps (first gradient, change) over the ranks' worst."""
    out = {}
    for name in reference.LEAVES:
        out[name] = [max(abs(v - ref[key][name]) / abs(ref[key][name]) for v in program[key][name])
                     for key in ("grad_norms", "change_norms")]
    return out


def _emit(kind: str, seed: int, program: dict, ref: dict) -> dict:
    line = {"reading": kind, "seed": seed, **compare.train_gaps(program, ref),
            "leaves": _leaves(program, ref)}
    print(json.dumps(line), flush=True)
    return line


def _as_program(ref: dict) -> dict:
    """A reference's readings in the program's place (one view)."""
    return {"losses": ref["losses"],
            "grad_norms": {n: [v] for n, v in ref["grad_norms"].items()},
            "change_norms": {n: [v] for n, v in ref["change_norms"].items()}}


def _calibrate_rank(rank: int, n: int, device, config: dict, traffic: dict, seeds: list,
                    faulted: int) -> list:
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checked, heads, lr = traffic["checked_steps"], config["n_heads"], config["lr"]
    refs, lines = {}, []

    def program(seed: int):
        job = train.Job(rank, n, device, config, traffic, seed)
        losses, grads, change, _ = job.checked(checked)
        views = train._share([grads, change], n)
        del job
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return train.readings(losses, views)

    def inputs(seed: int):
        return train.make_inputs(config, traffic, seed, device, checked)

    for i, seed in enumerate(seeds):
        readings = program(seed)
        if rank == 0:
            weights, xs = inputs(seed)
            refs[seed] = reference.train(weights, xs, heads, lr, steps=checked)
            lines.append(_emit("program", seed, readings, refs[seed]))
            if i < faulted:
                for kind, kwargs in (("control_tf32", {"tf32": True}),
                                     ("half_batch", {"half": True}),
                                     ("float64", {"dtype": torch.float64})):
                    other = reference.train(weights, xs, heads, lr, steps=checked, **kwargs)
                    lines.append(_emit(kind, seed, _as_program(other), refs[seed]))
            del weights, xs
        if n > 1:
            dist.barrier()
    if n > 1:
        faults.exchange_left_out()
        for seed in seeds[:faulted]:
            readings = program(seed)
            if rank == 0:
                lines.append(_emit("exchange_left_out", seed, readings, refs[seed]))
            dist.barrier()
    return lines if rank == 0 else None


def _controls(config: dict, traffic: dict, seeds: list) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    heads, lr, checked = config["n_heads"], config["lr"], traffic["checked_steps"]
    for seed in seeds:
        weights, xs = train.make_inputs(config, traffic, seed, torch.device("cuda", 0), checked)
        ref = reference.train(weights, xs, heads, lr, steps=checked)
        control = reference.train(weights, xs, heads, lr, steps=checked, tf32=True)
        _emit("control_tf32", seed, _as_program(control), ref)
        del weights, xs


def _gate(spec: Spec, name: str, seeds: list) -> None:
    from benchmark.harness import execute

    for patch in ("gate_bf16", "gate_answer_altered", "gate_half_rows", "gate_state_unchanged",
                  "gate_allreduce_altered"):
        for seed in seeds:
            out = execute(spec, name, seed, 1.0, False, time.monotonic(),
                          patch=f"benchmark.faults:{patch}")
            print(json.dumps({"reading": patch, "seed": seed, "correct": out["correct"],
                              **{k: c["value"] for k, c in out["compared"].items()}}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--first", type=int, default=FIRST_SEED)
    parser.add_argument("--control-only", action="store_true")
    args = parser.parse_args()
    spec = Spec()
    w = spec.workload(args.workload)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    if traffic["kind"] == "gate":
        _gate(spec, args.workload, seeds[:args.faults])
        return 0
    if args.control_only:
        _controls(config, traffic, seeds)
        return 0
    kwargs = dict(config=config, traffic=traffic, seeds=seeds, faulted=args.faults)
    if w["chips"] == 1:
        _calibrate_rank(0, 1, torch.device("cuda", 0), **kwargs)
    else:
        from tpu_operator_torch.workloads import _ranks

        _ranks.run(_calibrate_rank, w["chips"], "cuda", timeout_s=1500.0, **kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
