"""The command: without the cards a cell asks for it exits non-zero and
prints no result, also in a checkout of the benchmark alone; on a card
one short run prints the contract's line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.spec import ROOT


def _run(cwd, *args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", "benchmark", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(ROOT, "--workload", "train.s2048.x1", "--seed", "3", "--seconds", "1",
                "--trace", "0", env=env)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_benchmark_alone_runs_nothing(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(tmp_path, "--workload", "train.s2048.x1", "--seed", "3", "--seconds", "1",
                "--trace", "0", env=env)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_a_card_prints_the_line(card):
    proc = _run(ROOT, "--workload", "train.s2048.x1", "--seed", str(2**31 + 9), "--seconds", "2",
                "--trace", "0", timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s", "train_step_p95_ms"}
