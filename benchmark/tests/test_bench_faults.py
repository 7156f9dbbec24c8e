"""Whole runs at a tiny size on the CPU, the look for a card skipped: a
sound run comes out correct; the control and every fault a cell can have,
planted underneath the timed path, come out not correct."""

import time

import pytest
import torch

from benchmark import compare
from benchmark.harness import execute, finish, result_line
from benchmark.kinds import train
from benchmark.reference import layer as reference


def _run(spec, tiny, cell, patch="", trace=False):
    config, traffic = tiny(cell)
    return execute(spec, cell, 2**31 + 7, 0.3, trace, time.monotonic(), device="cpu",
                   patch=patch, config=config, traffic=traffic)


@pytest.mark.parametrize("cell", ["train.s2048.x1", "train.s32768.x1", "train.s2048.x4"])
def test_a_sound_training_run_is_correct(spec, tiny, cell):
    out = _run(spec, tiny, cell, trace=True)
    assert out["correct"], out["compared"]
    line = result_line(spec, cell, out, False)
    assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end(cell)}
    assert list(line)[-1] == "compared"
    assert out["attempted"] >= 2 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("train.s2048.x1", "state_unchanged"), ("train.s2048.x1", "half_batch"),
    ("train.s32768.x1", "state_unchanged"), ("train.s32768.x1", "half_batch"),
    ("train.s2048.x4", "state_unchanged"), ("train.s2048.x4", "half_batch"),
    ("train.s2048.x4", "exchange_left_out")])
def test_a_fault_under_the_training_step_is_not_correct(spec, tiny, cell, fault):
    out = _run(spec, tiny, cell, patch=f"benchmark.faults:{fault}")
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", ["train.s2048.x1", "train.s32768.x1", "train.s2048.x4"])
def test_the_control_fails_the_cells_limits(spec, tiny, cell):
    """The reference in TF32 in the program's place: it fails one of the
    cell's numbers, where the program does not."""
    config, traffic = tiny(cell)
    weights, xs = train.make_inputs(config, traffic, 5, torch.device("cpu"), 3)
    ref = reference.train(weights, xs, config["n_heads"], config["lr"], rows=8)
    control = reference.train(weights, xs, config["n_heads"], config["lr"], tf32=True, rows=8)
    as_program = {"losses": control["losses"],
                  "grad_norms": {n: [v] for n, v in control["grad_norms"].items()},
                  "change_norms": {n: [v] for n, v in control["change_norms"].items()}}
    correct, compared = compare.verdict(compare.train_gaps(as_program, ref),
                                        spec.cell(cell)["limits"])
    assert not correct, compared


def test_a_sound_gate_run_is_correct(gate_spec):
    out = execute(gate_spec, "gate.x1", 3, 0.1, True, time.monotonic(), device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 3, out["compared"]
    assert out["compared"]["vector_add_max_error"]["value"] == 0.0
    assert out["compared"]["allreduce_max_error"]["value"] == 0.0
    assert out["banned"] == []
    line = result_line(gate_spec, "gate.x1", out, True)
    assert {"gate.start_s", "gate.checks_s"} <= set(line["metrics"])
    assert line["metrics"]["gate.start_s"]["value"] > line["metrics"]["gate.checks_s"]["value"]


@pytest.mark.parametrize("patch,number", [
    ("benchmark.faults:gate_bf16", "vector_add_max_error"),
    ("benchmark.faults:gate_answer_altered", "vector_add_max_error"),
    ("benchmark.faults:gate_half_rows", "vector_add_max_error"),
    ("benchmark.faults:gate_state_unchanged", "vector_add_max_error"),
    ("benchmark.faults:gate_allreduce_altered", "allreduce_max_error"),
    ("benchmark.tests.test_bench_faults:quiet_half_rows", "vector_add_max_error")])
def test_a_fault_under_the_gate_is_not_correct(gate_spec, patch, number):
    """Each fault fails the benchmark's own comparison of the outputs, also
    where the program's own check reports nothing wrong."""
    out = execute(gate_spec, "gate.x1", 3, 0.1, False, time.monotonic(), device="cpu", patch=patch)
    assert not out["correct"], out["compared"]
    assert out["compared"][number]["value"] > 0.0


def quiet_half_rows() -> None:
    """Planted in a gate pass: half of B1's rows left unsummed, and the
    vector-add check made to report itself ok with no error."""
    from benchmark import faults
    from tpu_operator_torch.workloads import collectives

    faults.gate_half_rows()
    check = collectives.vector_add

    def quiet(*args, **kwargs):
        return dict(check(*args, **kwargs), ok=True, max_error=0.0)

    collectives.vector_add = quiet


def test_a_gate_pass_that_loads_the_jax_package_prints_no_result(gate_spec, capsys):
    out = execute(gate_spec, "gate.x1", 3, 0.1, False, time.monotonic(), device="cpu",
                  patch="benchmark.faults:loads_jax_package")
    assert out["banned"] == ["tpu_operator.x"]
    assert finish(gate_spec, "gate.x1", out, False) != 0
    printed, err = capsys.readouterr()
    assert printed == "" and "tpu_operator.x" in err
