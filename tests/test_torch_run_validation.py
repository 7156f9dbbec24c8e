"""The port's gate entry point (``tpu_operator_torch.workloads.
run_validation``) against the reference's contract: check names, JSON lines,
the device-count short circuit, the budget skip, and a drop-box and flight
record the unchanged validator reads.  Runs on the CPU via TORCH_DEVICE=cpu.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from tpu_operator.validator import status as jstatus  # noqa: E402
from tpu_operator.workloads import run_validation as jrv  # noqa: E402
from tpu_operator_torch.validator import status as tstatus  # noqa: E402
from tpu_operator_torch.workloads import run_validation as rv  # noqa: E402


@pytest.fixture
def cpu_gate(validation_root, monkeypatch):
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ALLREDUCE_SIZE_MB", "2")
    for var in ("WORKLOAD_CHECKS", "EXPECTED_DEVICES", "WORKLOAD_BUDGET_S",
                "WORKLOAD_START_BARRIER", "RESULTS_SCOPE", "TPU_METRICS_PUSH_URL",
                "TPU_TRACEPARENT", "DEVICE_COUNT_GATE_BACKENDS"):
        monkeypatch.delenv(var, raising=False)
    return validation_root


def _lines(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_check_names_match_reference():
    assert set(rv.check_runners()) == jrv.known_checks()
    assert rv.known_checks() == jrv.known_checks()


def test_gate_passes_on_cpu(cpu_gate, monkeypatch, capsys):
    monkeypatch.setenv("WORKLOAD_CHECKS", "vector-add,allreduce")
    monkeypatch.setenv("TPU_TRACEPARENT", "abc123-def456")
    assert rv.main() == 0
    lines = _lines(capsys)
    assert [line["check"] for line in lines] == ["vector-add", "allreduce"]
    assert all(line["ok"] and line["backend"] == "cpu" for line in lines)
    # the reference's reader sees the port's drop-box and flight record
    results = jstatus.read_workload_results()
    assert set(results["checks"]) == {"vector-add", "allreduce"}
    samples = jstatus.read_flight_record()
    assert {s["check"] for s in samples} == {"vector-add", "allreduce"}
    assert all(s["trace_id"] == "abc123" and s["span_id"] for s in samples)
    assert {s["phase"] for s in samples} >= {"compile", "step", "step-window", "result"}


def test_default_checks_are_the_gate(cpu_gate, capsys):
    assert rv.main() == 0
    lines = _lines(capsys)
    assert [line["check"] for line in lines] == ["vector-add", "allreduce", "burn-in"]
    burn = lines[-1]
    assert burn["ok"] and burn["mesh"] == {"dp": 1, "mp": 1} and len(burn["losses"]) == 3


def test_expected_devices_short_circuits(cpu_gate, monkeypatch, capsys):
    monkeypatch.setenv("WORKLOAD_CHECKS", "vector-add")
    monkeypatch.setenv("DEVICE_COUNT_GATE_BACKENDS", "cpu")
    monkeypatch.setenv("EXPECTED_DEVICES", "1")
    assert rv.main() == 0  # one CPU rank: the count matches, checks proceed
    assert [line["check"] for line in _lines(capsys)] == ["devices", "vector-add"]

    monkeypatch.setenv("EXPECTED_DEVICES", "4")
    assert rv.main() == 1
    lines = _lines(capsys)
    # ONLY the devices line: the remaining checks would measure the wrong
    # topology and bury the real failure
    assert [line["check"] for line in lines] == ["devices"] and not lines[0]["ok"]
    assert tstatus.read_workload_results()["checks"]["devices"]["expected"] == 4

    monkeypatch.setenv("EXPECTED_DEVICES", "two")
    assert rv.main() == 1
    assert "malformed" in _lines(capsys)[0]["error"]


def test_budget_skips_but_unknown_names_still_fail(cpu_gate, monkeypatch, capsys):
    monkeypatch.setenv("WORKLOAD_BUDGET_S", "1e-9")
    monkeypatch.setenv("WORKLOAD_CHECKS", "vector-add,no-such-check")
    assert rv.main() == 1
    skipped, unknown = _lines(capsys)
    assert skipped["ok"] and "budget" in skipped["skipped"]
    assert not unknown["ok"] and unknown["error"] == "unknown check no-such-check"


def test_long_context_checks_pass_on_cpu(cpu_gate, monkeypatch, capsys):
    """longctx, decode and ring-attention at their CPU shapes through the
    entry point, with the reference's drop-box and flight record."""
    monkeypatch.setenv("WORKLOAD_CHECKS", "longctx,decode,ring-attention")
    assert rv.main() == 0
    lines = _lines(capsys)
    assert [line["check"] for line in lines] == ["longctx", "decode", "ring-attention"]
    assert all(line["ok"] and line["backend"] == "cpu" for line in lines)
    assert lines[0]["seq"] == 256 and lines[0]["max_error"] < 2e-2
    assert lines[2]["seq"] == 16 and lines[2]["max_error"] < 2e-2
    results = jstatus.read_workload_results()
    assert set(results["checks"]) == {"longctx", "decode", "ring-attention"}
    samples = jstatus.read_flight_record()
    assert {s["check"] for s in samples} == {"longctx", "decode", "ring-attention"}


def test_training_checks_pass_on_cpu(cpu_gate, monkeypatch, capsys):
    """transformer and train at their CPU shapes through the entry point,
    with the reference's drop-box and flight record."""
    monkeypatch.setenv("WORKLOAD_CHECKS", "transformer,train")
    assert rv.main() == 0
    lines = _lines(capsys)
    assert [line["check"] for line in lines] == ["transformer", "train"]
    assert all(line["ok"] and line["backend"] == "cpu" for line in lines)
    transformer, train = lines
    losses = transformer["losses"]
    assert transformer["mesh"] == {"dp": 1, "mp": 1} and losses[-1] < losses[0]
    assert train["attention_kernel"] == "plain" and train["tokens_per_sec"] > 0
    results = jstatus.read_workload_results()
    assert set(results["checks"]) == {"transformer", "train"}
    samples = jstatus.read_flight_record()
    assert {s["check"] for s in samples} == {"transformer", "train"}
    assert {s["phase"] for s in samples if s["check"] == "train"} >= {"compile", "step", "result"}


def test_every_reference_check_runs_in_the_port():
    """The dispatch holds exactly the reference's 18 names, and none is a
    stub: the last two, transformer-pp and warm-pool, run their modules."""
    runners = rv.check_runners()
    assert set(runners) == jrv.known_checks() and len(runners) == 18
    assert not hasattr(rv, "NOT_PORTED") and not hasattr(rv, "_UNPORTED")
    assert runners["transformer-pp"].__module__ == "tpu_operator_torch.workloads.collectives"


@pytest.mark.parametrize("check", ["transformer-pp", "warm-pool"])
def test_last_two_checks_pass_on_cpu(cpu_gate, monkeypatch, capsys, tmp_path, check):
    """transformer-pp and warm-pool through the entry point on the CPU, with
    the reference's JSON line, drop-box entry and flight samples."""
    monkeypatch.setenv("WORKLOAD_CHECKS", check)
    monkeypatch.setenv("TPU_COMPILE_CACHE_ARTIFACTS", str(tmp_path / "artifacts"))
    monkeypatch.delenv("TPU_FLEET_CACHE_URL", raising=False)
    assert rv.main() == 0
    (line,) = _lines(capsys)
    assert line["check"] == check and line["ok"] and line["duration_s"] > 0
    if check == "transformer-pp":
        losses = line["losses"]
        assert line["mesh"] == {"pp": 1, "dp": 1, "mp": 1} and line["pp_degenerate"]
        assert len(losses) == 3 and all(b < a for a, b in zip(losses, losses[1:]))
        assert line["attention_kernel"] == "plain" and line["backend"] == "cpu"
        phases = {"compile", "step", "step-window", "result"}
    else:
        assert line["programs"] == 3 and (line["hits"], line["misses"]) == (0, 0)
        assert all(r["finite"] for r in line["results"].values())
        phases = {"cache", "result"}
    results = jstatus.read_workload_results()
    assert set(results["checks"]) == {check} and results["checks"][check]["ok"]
    samples = jstatus.read_flight_record()
    checks = {check, "compile-cache"} if check == "warm-pool" else {check}
    assert {s["check"] for s in samples} == checks
    assert {s["phase"] for s in samples} >= phases


def test_serving_passes_on_cpu(cpu_gate, monkeypatch, capsys):
    """The serving check under the perf pod's RESULTS_SCOPE: sequential and
    batched scheduling give identical streams; the reference's reader finds
    the entry in the scoped drop-box."""
    monkeypatch.setenv("WORKLOAD_CHECKS", "serving")
    monkeypatch.setenv("RESULTS_SCOPE", "perf")
    assert rv.main() == 0
    (line,) = _lines(capsys)
    assert line["check"] == "serving" and line["ok"] and line["identical_outputs"]
    assert line["backend"] == "cpu" and line["batched"]["completed"] == line["n_requests"] == 8
    assert line["sequential"]["steps"] > line["batched"]["steps"]
    results = jstatus.read_workload_results("perf")
    assert results["checks"]["serving"]["identical_outputs"] is True


def test_perf_probes_pass_on_cpu(cpu_gate, monkeypatch, capsys):
    """matmul, hbm, hbm-dma and ring through the entry point under the
    perf-probes pod's RESULTS_SCOPE: the reference's reader finds the
    drop-box and the flight record at the reference's perf paths."""
    monkeypatch.setenv("WORKLOAD_CHECKS", "matmul,hbm,hbm-dma,ring")
    monkeypatch.setenv("RESULTS_SCOPE", "perf")
    for var in ("HBM_SIZE_MB", "HBM_ITERS", "HBM_BEST_OF", "MATMUL_MIN_MFU"):
        monkeypatch.delenv(var, raising=False)
    assert rv.main() == 0
    lines = _lines(capsys)
    assert [line["check"] for line in lines] == ["matmul", "hbm", "hbm-dma", "ring"]
    assert all(line["ok"] and line["backend"] == "cpu" for line in lines)
    matmul, hbm, dma, ring = lines
    assert [r["size"] for r in matmul["results"]] == [256] and matmul["mfu"] is None
    assert hbm["size_mb"] == 8 * 1024 * 1024 / 1e6 and hbm["iters"] == 4  # the CPU's toy stream
    assert dma["kernel"] == "plain" and dma["methodology"] == "pallas-dma-pipeline"
    assert "skipped" in ring and ring["transport"] == "hbm-local"  # one CPU rank
    assert jstatus.read_workload_results() is None  # the gating run's drop-box untouched
    results = jstatus.read_workload_results("perf")
    assert set(results["checks"]) == {"matmul", "hbm", "hbm-dma", "ring"}
    samples = jstatus.read_flight_record("perf")
    assert {s["check"] for s in samples} == {"matmul", "hbm", "hbm-dma", "ring"}
    assert {s["phase"] for s in samples if s["check"] == "matmul"} >= {"compile", "step",
                                                                       "result"}


def test_parallelism_census_on_cpu(cpu_gate, monkeypatch, capsys):
    """ulysses, moe and pipeline through the entry point under the
    perf-probes pod's RESULTS_SCOPE, at their CPU sizes: one JSON line and
    one drop-box entry each, with the reference's strategy tags and each
    module's own bound (the reference's test_run_validation_parallelism_
    census)."""
    monkeypatch.setenv("WORKLOAD_CHECKS", "ulysses,moe,pipeline")
    monkeypatch.setenv("RESULTS_SCOPE", "perf")
    assert rv.main() == 0
    lines = _lines(capsys)
    assert [line["check"] for line in lines] == ["ulysses", "moe", "pipeline"]
    assert all(line["ok"] and line["backend"] == "cpu" and line["devices"] == 1
               for line in lines)
    ulysses, moe, pipeline = lines
    assert ulysses["strategy"] == "ulysses-all-to-all" and ulysses["max_error"] < 2e-2
    assert moe["strategy"] == "ep-all-to-all-top1" and moe["max_error"] < 1e-4
    assert pipeline["strategy"] == "pp-gpipe-microbatch" and pipeline["max_error"] < 1e-3
    assert ulysses["seq"] == 16 and moe["tokens"] == 64 and pipeline["ticks"] == 8
    results = jstatus.read_workload_results("perf")
    assert set(results["checks"]) == {"ulysses", "moe", "pipeline"}
    assert all(results["checks"][c]["duration_s"] > 0 for c in results["checks"])
    samples = jstatus.read_flight_record("perf")
    assert {s["check"] for s in samples} == {"ulysses", "moe", "pipeline"}


def test_probe_gates_on_cpu_are_report_only(cpu_gate, monkeypatch, capsys):
    """The minimums are recorded but never enforced on the CPU (the gates
    default to cuda), and the env sizes stay the card's."""
    monkeypatch.setenv("WORKLOAD_CHECKS", "hbm,ring")
    monkeypatch.setenv("HBM_SIZE_MB", "4096")  # a card's size: the CPU runs its toy stream
    monkeypatch.setenv("HBM_MIN_GBPS", "1e9")
    monkeypatch.setenv("RING_MIN_GBPS", "1e9")
    assert rv.main() == 0
    hbm, ring = _lines(capsys)
    assert hbm["size_mb"] == 8 * 1024 * 1024 / 1e6
    assert hbm["min_gbps"] == ring["min_gbps"] == 1e9
    assert not hbm["gated"] and not ring["gated"]


def test_start_barrier_times_out_alone(cpu_gate, monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("WORKLOAD_START_BARRIER", str(tmp_path / "barrier"))
    monkeypatch.setenv("WORKLOAD_BARRIER_COUNT", "2")
    monkeypatch.setenv("WORKLOAD_BARRIER_TIMEOUT_S", "0.2")
    assert rv.main() == 1
    (line,) = _lines(capsys)
    assert line["check"] == "start-barrier" and "1/2" in line["error"]


@pytest.mark.parametrize("scope", ["", "perf"])
def test_dropbox_paths_match_reference(validation_root, scope):
    assert tstatus.validation_dir() == jstatus.validation_dir()
    assert tstatus.workload_results_path(scope) == jstatus.workload_results_path(scope)
    assert tstatus.flight_record_path(scope) == jstatus.flight_record_path(scope)


def test_dropbox_default_paths_match_reference(monkeypatch):
    monkeypatch.delenv("TPU_VALIDATION_ROOT", raising=False)
    assert tstatus.workload_results_path() == jstatus.workload_results_path()
    assert tstatus.flight_record_path() == jstatus.flight_record_path()


def test_results_round_trip_both_ways(validation_root):
    tstatus.write_workload_results({"checks": {"a": {"ok": True}}}, scope="perf")
    assert jstatus.read_workload_results("perf")["checks"] == {"a": {"ok": True}}
    jstatus.write_workload_results({"checks": {"b": {"ok": False}}})
    assert tstatus.read_workload_results()["checks"] == {"b": {"ok": False}}
