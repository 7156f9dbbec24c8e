"""The port's multi-host program (``python -m tpu_operator_torch.workloads.
distributed``) on the CPU: real host processes of gloo ranks against a
local rendezvous store, as the reference's ``tests/test_workloads.py``
runs its workers, with fault injection; the post-mortem against the
reference's on the same outcomes; and the exit paths, which must leave no
rank of a host alive."""

import json
import re
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator.validator import status as jstatus  # noqa: E402
from tpu_operator.workloads import distributed as jdist  # noqa: E402
from tpu_operator_torch.workloads import collectives  # noqa: E402
from tpu_operator_torch.workloads import distributed  # noqa: E402
from tpu_operator_torch.workloads import watchdog  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_KEYS = {"process_id", "num_processes", "global_devices", "local_devices", "mesh",
               "devices_check", "psum", "allreduce", "ring", "ring_attention", "moe",
               "losses", "backend"}


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "TORCH_DEVICE"}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _dead(pid: int) -> bool:
    """Gone, or a zombie nobody has reaped yet."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _rank_pids(outcomes) -> list:
    pids = []
    for o in outcomes:
        for line in (o["stdout_tail"] or "").splitlines():
            if line.startswith("{") and "local_rank_pids" in line:
                pids += json.loads(line)["local_rank_pids"]
    return pids


def _assert_no_rank_outlives(pids, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not all(map(_dead, pids)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert all(map(_dead, pids)), [p for p in pids if not _dead(p)]


def test_four_host_rendezvous(validation_root):
    """4 hosts x 2 ranks: the host count exceeds the mesh's dp axis (dp 2,
    mp 4), and the device-count truth counts 2 local and 8 global ranks
    (the reference's test_distributed_four_process_rendezvous)."""
    outcomes = distributed.spawn_local_workers_outcomes(
        4, 2, steps=2, timeout=120, device="cpu", extra_env={
            "ALLREDUCE_SIZE_MB": "1",
            "EXPECTED_DEVICES": "2",
            "DEVICE_COUNT_GATE_BACKENDS": "cpu,cuda",
        })
    assert [o["returncode"] for o in outcomes] == [0, 0, 0, 0], outcomes[0]["stderr_tail"]
    for o in outcomes:
        result = o["result"]
        assert result["ok"] and RESULT_KEYS <= set(result)
        assert result["num_processes"] == 4 and result["global_devices"] == 8
        assert result["local_devices"] == 2
        assert result["mesh"] == {"dp": 2, "mp": 4}
        assert result["psum"] == {"total": 20.0, "expected": 20.0, "ok": True}
        assert result["devices_check"]["gated"]
        assert result["devices_check"]["visible_global"] == 8
        assert result["ring"]["max_error"] == 0.0 and result["ring"]["hops"] == 16
        assert result["ring_attention"]["seq"] == 64
        assert result["moe"]["experts"] == 8 and result["moe"]["max_error"] < 1e-4
        losses = result["losses"]
        assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] < losses[0]
    assert jstatus.read_workload_results()["distributed"]["ok"]
    _assert_no_rank_outlives(_rank_pids(outcomes))


def test_host_death_at_psum_detected_bounded(validation_root):
    """SIGKILL host 1 at the psum phase: the survivors fail by themselves,
    well inside the pod budget, with evidence naming the dead member and
    the phase; host 1's rank dies with it.  (gloo errors out of the
    collective at once, so a survivor here fails on its own or by its
    watchdog; NCCL hangs there, and only the watchdog ends it: the card
    smoke run holds host 0 to that.)"""
    outcomes = distributed.spawn_local_workers_outcomes(
        3, 2, steps=2, timeout=120, device="cpu",
        extra_env={"FAULT_INJECT": "psum:1", "WATCHDOG_TIMEOUT_S": "5",
                   "ALLREDUCE_SIZE_MB": "1"})
    pm = distributed.rendezvous_post_mortem(outcomes)
    assert not pm["ok"]
    assert 1 in pm["dead_members"]
    assert pm["survivors_failed_bounded"]
    assert pm["max_survivor_elapsed_s"] < 90
    by_id = {w["process_id"]: w for w in pm["workers"]}
    assert by_id[1]["outcome"] == "killed"
    for pid in (0, 2):
        assert by_id[pid]["outcome"] in ("watchdog-peer-death", "failed")
        assert by_id[pid]["returncode"] != 0 and by_id[pid]["phase"] == "psum"
        if by_id[pid]["outcome"] == "watchdog-peer-death":
            assert by_id[pid]["returncode"] == watchdog.WATCHDOG_EXIT_CODE
            assert by_id[pid]["dead_members"] == [1]
    evidence = jstatus.read_workload_results()["distributed"]
    assert evidence["ok"] is False
    assert not jstatus.is_ready("jax")
    _assert_no_rank_outlives(_rank_pids(outcomes))


def test_coordinator_death_detected_bounded(validation_root):
    """SIGKILL host 0, the store's host, at the allreduce phase: every
    survivor fails in bounded time, member 0 is named dead."""
    outcomes = distributed.spawn_local_workers_outcomes(
        3, 2, steps=2, timeout=120, device="cpu",
        extra_env={"FAULT_INJECT": "allreduce:0", "WATCHDOG_TIMEOUT_S": "5",
                   "ALLREDUCE_SIZE_MB": "1"})
    pm = distributed.rendezvous_post_mortem(outcomes)
    assert not pm["ok"]
    assert 0 in pm["dead_members"]
    assert pm["survivors_failed_bounded"]
    assert pm["max_survivor_elapsed_s"] < 90
    for w in pm["workers"]:
        if w["process_id"] == 0:
            assert w["outcome"] == "killed"
            continue
        assert w["outcome"] in ("watchdog-coordinator-loss", "aborted-coordinator-loss",
                                "failed")
        assert w["returncode"] != 0
    assert not jstatus.is_ready("jax")
    _assert_no_rank_outlives(_rank_pids(outcomes))


def test_device_count_mismatch_fails_every_host(validation_root):
    """Hosts of 2 ranks where the node promised 4: each fails the
    device-count truth with the counts, and skips the remaining phases."""
    outcomes = distributed.spawn_local_workers_outcomes(
        2, 2, timeout=120, device="cpu",
        extra_env={"EXPECTED_DEVICES": "4", "DEVICE_COUNT_GATE_BACKENDS": "cpu"})
    for o in outcomes:
        result = o["result"]
        assert o["returncode"] == 1 and result["ok"] is False
        check = result["devices_check"]
        assert (check["visible"], check["expected"]) == (2, 4)
        assert (check["visible_global"], check["expected_global"]) == (4, 8)
        assert "psum" not in result


def test_single_host_runs_in_process(validation_root, monkeypatch):
    """One host of one rank needs no store: the phases run in-process, the
    ring is skipped, and the armed allreduce gate applies only on the
    backends it names (the reference's test_distributed_reports_and_gates_
    allreduce)."""
    monkeypatch.delenv(distributed.CPU_RANKS_ENV, raising=False)
    monkeypatch.setenv("ALLREDUCE_SIZE_MB", "1")
    result = distributed.run_worker("", 1, 0, steps=2, device="cpu")
    assert result["ok"] and result["mesh"] == {"dp": 1, "mp": 1}
    assert result["global_devices"] == result["local_devices"] == 1
    assert result["allreduce"]["transport"] == "hbm-local"
    assert "hops" not in result["ring"] and result["ring"]["ok"]
    assert result["allreduce"]["gated"] is False

    fake = {"ok": True, "devices": 2, "size_mb": 1.0, "transport": "nvlink",
            "backend": "cpu", "overhead_dominated": False,
            "busbw_gbps": 0.5, "algbw_gbps": 0.4}
    monkeypatch.setattr(collectives, "_allreduce_rank", lambda *a, **kw: dict(fake))
    monkeypatch.setenv("ALLREDUCE_MIN_GBPS", "1000000")
    assert distributed.run_worker("", 1, 0, steps=2, device="cpu")["ok"]
    monkeypatch.setenv("ALLREDUCE_GATE_BACKENDS", "cpu,cuda")
    result = distributed.run_worker("", 1, 0, steps=2, device="cpu")
    assert not result["ok"] and "busbw" in result["allreduce"]["error"]
    assert result["allreduce"]["min_gbps"] == 1000000


@pytest.mark.parametrize("env, error", [
    ({"CUDA_VISIBLE_DEVICES": ""}, "no CUDA device"),
    ({"TORCH_DEVICE": "cpu", "NUM_PROCESSES": "2"}, "COORDINATOR_ADDRESS required"),
], ids=["no-card", "no-coordinator"])
def test_program_fails_and_says_why(tmp_path, env, error):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.workloads.distributed"], cwd=REPO,
        env=_env(TPU_VALIDATION_ROOT=str(tmp_path), **env),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and error in last["error"]


_HOST = """
import json, os, signal, sys, time
from tpu_operator_torch.workloads import distributed, watchdog

class StalledPeer:
    store = {"tpuop/watchdog/hb/1": "1", "tpuop/watchdog/phase/1": "psum"}
    def key_value_set(self, key, value, overwrite=True):
        self.store[key] = value
    def key_value_try_get(self, key):
        if key not in self.store:
            raise KeyError("NOT_FOUND: " + key)
        return self.store[key]

if __name__ == "__main__":
    # ranks that wait for a store nobody serves: alive until killed, or,
    # for rank-fails, failing after 2 s
    spec = {"address": "127.0.0.1:%d" % distributed.free_ports(1)[0], "device": "cpu",
            "local": 3, "first_rank": 0, "world": 3, "process_id": 0,
            "num_processes": 2, "steps": 1, "d_model": 8, "d_hidden": 8,
            "init_timeout_s": 2 if sys.argv[1] == "rank-fails" else 120}
    ranks = distributed.LocalRanks(spec, "")
    ranks.start()
    print(json.dumps({"local_rank_pids": [p.pid for p in ranks.procs]}), flush=True)
    time.sleep(3)  # the ranks are up
    if sys.argv[1] == "watchdog":
        wd = watchdog.PeerWatchdog(StalledPeer(), 0, 2, timeout=0.5, interval=0.1,
                                   exit_fn=ranks.hard_exit)
        wd.start()
    if sys.argv[1] != "sigkill":
        time.sleep(60)  # the watchdog or the rank monitor ends this host
    os.kill(os.getpid(), signal.SIGKILL)
"""


@pytest.mark.parametrize("how, rc", [("watchdog", watchdog.WATCHDOG_EXIT_CODE),
                                     ("sigkill", -9), ("rank-fails", 1)])
def test_no_rank_outlives_its_host(tmp_path, how, rc):
    """The watchdog's hard exit kills the host's ranks first; a host that
    is SIGKILLed takes them with it (their parent-death signal); a rank
    that fails fails its host at once, with evidence, through the rank
    monitor."""
    script = tmp_path / "host.py"
    script.write_text(_HOST)
    proc = subprocess.run([sys.executable, str(script), how], cwd=REPO,
                          env=_env(TPU_VALIDATION_ROOT=str(tmp_path)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stderr
    pids = json.loads(proc.stdout.splitlines()[0])["local_rank_pids"]
    assert len(pids) == 2
    _assert_no_rank_outlives(pids)
    evidence = json.loads(proc.stdout.strip().splitlines()[-1])
    if how == "watchdog":
        assert evidence["fault"]["type"] == "peer-heartbeat-lost"
    if how == "rank-fails":
        # both spawned ranks fail alike (each waits 2 s for a store nobody
        # serves), so the monitor names whichever it sees exit first
        assert evidence["ok"] is False
        assert re.search(r"local-rank[12] exited 1", evidence["error"]), evidence["error"]
        assert json.loads((tmp_path / "workload-results" / "results.json").read_text()
                          )["distributed"]["error"] == evidence["error"]


_OUTCOMES = {
    "killed-despite-harness-timeout": [
        {"process_id": 0, "returncode": 3, "elapsed_s": 1.0, "timed_out": False,
         "result": {"fault": {"type": "peer-heartbeat-lost",
                              "dead_members": [{"process_id": 1}]}, "phase": "psum"}},
        {"process_id": 1, "returncode": -9, "elapsed_s": 5.0, "timed_out": True,
         "result": None,
         "stdout_tail": json.dumps({"fault_injected": "psum", "process_id": 1})},
    ],
    "all-hang-is-not-killed": [
        {"process_id": i, "returncode": -9, "elapsed_s": 300.0, "timed_out": True,
         "result": None, "stdout_tail": ""} for i in range(2)
    ],
    "coordinator-unreachable": [
        {"process_id": 0, "returncode": -9, "elapsed_s": 2.0, "timed_out": False,
         "result": None, "stdout_tail": '{"fault_injected": "allreduce"}'},
        {"process_id": 1, "returncode": 3, "elapsed_s": 8.0, "timed_out": False,
         "result": {"fault": {"type": "coordinator-unreachable",
                              "dead_members": [{"process_id": 0, "phase": None}]},
                    "phase": "allreduce"}},
        {"process_id": 2, "returncode": 1, "elapsed_s": 3.0, "timed_out": False,
         "result": {"ok": False, "phase": "allreduce", "error": "Connection reset"}},
    ],
    "healthy": [
        {"process_id": i, "returncode": 0, "elapsed_s": 9.0, "timed_out": False,
         "result": {"ok": True}} for i in range(2)
    ],
}


@pytest.mark.parametrize("case", sorted(_OUTCOMES))
def test_post_mortem_matches_reference(case):
    """The same outcomes classify alike under the port and the reference;
    the reference's two ADVICE cases included (a fault-killed host that
    crossed the harness deadline is 'killed'; harness kills of hung hosts
    with no injected fault are not deaths)."""
    outcomes = _OUTCOMES[case]
    mine = distributed.rendezvous_post_mortem(outcomes)
    assert mine == jdist.rendezvous_post_mortem(outcomes)
    if case == "killed-despite-harness-timeout":
        by_id = {w["process_id"]: w for w in mine["workers"]}
        assert by_id[1]["outcome"] == "killed" and by_id[1]["timed_out"] is True
        assert mine["dead_members"] == [1] and mine["survivors_failed_bounded"] is True
    if case == "all-hang-is-not-killed":
        assert all(w["outcome"] == "failed" for w in mine["workers"])
        assert mine["dead_members"] == [] and mine["survivors_failed_bounded"] is None


def test_post_mortem_reads_a_lost_store_as_coordinator_loss():
    """A host whose main thread failed on the dead coordinator's store is
    its victim, not the fault."""
    outcomes = [
        {"process_id": 0, "returncode": -9, "elapsed_s": 2.0, "timed_out": False,
         "result": None, "stdout_tail": '{"fault_injected": "burn-in"}'},
        {"process_id": 1, "returncode": 1, "elapsed_s": 3.0, "timed_out": False,
         "result": {"ok": False, "phase": "burn-in", "error": (
             "Failed to recv, got 0 bytes. Connection was likely closed. "
             "Did the remote server shutdown or crash?")}},
    ]
    pm = distributed.rendezvous_post_mortem(outcomes)
    assert [w["outcome"] for w in pm["workers"]] == ["killed", "aborted-coordinator-loss"]
    assert pm["dead_members"] == [0] and pm["survivors_failed_bounded"]


def test_free_ports_are_distinct():
    ports = distributed.free_ports(8)
    assert len(set(ports)) == 8
