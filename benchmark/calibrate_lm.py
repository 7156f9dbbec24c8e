"""``python -m benchmark.calibrate_lm --workload <cell> --seeds N --faults M``:
the readings that a language-model cell's limits are set from, taken on
the card at the cell's own size (never by a benchmark run).

On each of N seeds the program's numbers (set-up and the checked steps as
a run makes them) against the reference; on the first C seeds
(``--controls``) also the control, the reference with every product in
TF32 put in the program's place, and on the first M (``--faults``) each
fault of ``faults_lm`` planted in the program.  A state
left unchanged reads 1 by the measure and needs no run.  One JSON line a
reading on standard output, with the worst leaves' gaps.  The tokens'
gaps of the control (every token's loss moves) against the program's (a
flip moves a few) are what ``compare_lm.token_gap``'s limit is set
from."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import compare_lm, faults_lm
from benchmark.kinds import lm_train
from benchmark.spec import Spec

FIRST_SEED = 2_000_003


def _emit(kind: str, seed: int, program: dict, ref: dict) -> None:
    leaves = {n: [abs(program[key][n][0] - ref[key][n]) / abs(ref[key][n])
                  for key in ("grad_norms", "change_norms")] for n in ref["grad_norms"]}
    worst = sorted(leaves.items(), key=lambda kv: -kv[1][0])[:6]
    print(json.dumps({"reading": kind, "seed": seed, **compare_lm.train_gaps(program, ref),
                      "losses": program["losses"], "ref_losses": ref["losses"],
                      "worst_leaves": worst}), flush=True)


def _program(config: dict, traffic: dict, seed: int, device) -> dict:
    job = lm_train.Job(device, config, traffic, seed)
    losses, grads, change, _, tokens = job.checked(traffic["checked_steps"])
    del job
    torch.cuda.empty_cache()
    return lm_train.readings(losses, grads, change, tokens)


def _reference(config: dict, traffic: dict, seed: int, device, tf32: bool = False) -> dict:
    out = lm_train.reference_readings(config, traffic, seed, device, traffic["checked_steps"],
                                      tf32)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(prog="python -m benchmark.calibrate_lm")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--faults", type=int, default=2)
    parser.add_argument("--controls", type=int, default=2)
    parser.add_argument("--first-seed", type=int, default=FIRST_SEED)
    args = parser.parse_args()
    spec = Spec()
    w = spec.workload(args.workload)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, seed in enumerate(args.first_seed + 7919 * k for k in range(args.seeds)):
        program = _program(config, traffic, seed, device)
        ref = _reference(config, traffic, seed, device)
        _emit("program", seed, program, ref)
        if i < args.controls:
            control = _reference(config, traffic, seed, device, tf32=True)
            as_program = {"losses": control["losses"], "token_losses": control["token_losses"],
                          **{key: {n: [v] for n, v in control[key].items()}
                             for key in ("grad_norms", "change_norms")}}
            _emit("control_tf32", seed, as_program, ref)
        if i < args.faults:
            for name in faults_lm.FAULTS:
                with faults_lm.planted(name):
                    _emit(name, seed, _program(config, traffic, seed, device), ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
