"""The no-JAX check compares whole top-level names: the port, whose name
begins with the JAX package's, passes; the JAX package fails."""

import subprocess
import sys

from benchmark import harness, modcheck
from benchmark.spec import ROOT


def test_top_level_names_compared_whole():
    names = ["tpu_operator_torch", "tpu_operator_torch.workloads.collectives", "jaxtyping",
             "tpu_operators", "numpy"]
    assert modcheck.banned_modules(names) == []
    assert modcheck.banned_modules(names + ["tpu_operator.x", "jax", "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib.xla", "tpu_operator.x"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, spec, capsys):
    monkeypatch.setitem(sys.modules, "tpu_operator.fake", object())
    outcome = {"banned": [], "correct": True}
    assert harness.finish(spec, "train.s2048.x1", outcome, False) == 3
    out, err = capsys.readouterr()
    assert out == "" and "tpu_operator.fake" in err


def test_a_rank_that_loaded_jax_fails_the_run(spec, capsys):
    assert harness.finish(spec, "train.s2048.x1", {"banned": ["jax"]}, False) == 3
    assert capsys.readouterr().out == ""


def test_the_harness_and_the_port_load_no_jax():
    code = ("import benchmark.harness, benchmark.kinds.train, benchmark.kinds.gate, "
            "benchmark.calibrate, benchmark.gate_child, benchmark.faults\n"
            "import tpu_operator_torch.workloads.collectives, tpu_operator_torch.workloads._ranks\n"
            "from benchmark import modcheck\nprint(modcheck.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"
