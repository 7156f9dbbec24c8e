"""The port's peer watchdog (``tpu_operator_torch.workloads.watchdog``):
the reference's own unit cases (``tests/test_workloads.py``'s fake KV
client) against the port's copy, the store adapter on a real
``TCPStore``, and the exit path's evidence in the drop-box the reference's
reader sees."""

import time

import pytest

torch = pytest.importorskip("torch")

from tpu_operator.validator import status as jstatus  # noqa: E402
from tpu_operator_torch.workloads import distributed  # noqa: E402
from tpu_operator_torch.workloads import watchdog  # noqa: E402


class _FakeKV:
    """Minimal coordination-service KV double (key_value_set/try_get)."""

    def __init__(self):
        self.store = {}

    def key_value_set(self, key, value, overwrite=True):
        self.store[key] = value

    def key_value_try_get(self, key):
        if key not in self.store:
            raise RuntimeError(f"NOT_FOUND: {key}")
        return self.store[key]


def _wait_for(cond, seconds=2.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)


def _watchdog(kv, exits, timeout=0.05):
    return watchdog.PeerWatchdog(kv, 0, 2, timeout=timeout, interval=0.01,
                                 exit_fn=exits.append)


def test_watchdog_skips_cleanly_done_peer(validation_root):
    """A peer that published the terminal phase and exited (its beat never
    advances again) is not declared dead."""
    kv, exits = _FakeKV(), []
    wd = _watchdog(kv, exits)
    kv.key_value_set(f"{watchdog._KV_PREFIX}/hb/1", "1", True)
    kv.key_value_set(f"{watchdog._KV_PREFIX}/phase/1", watchdog.TERMINAL_PHASE, True)
    wd.start()
    time.sleep(0.3)  # many intervals past the 0.05 s timeout
    wd.stop()
    assert exits == []


def test_watchdog_declares_stalled_midrun_peer_dead(validation_root):
    """The same stall in a non-terminal phase is a death, with the
    reference's evidence in the drop-box the reference reads."""
    kv, exits = _FakeKV(), []
    wd = _watchdog(kv, exits)
    kv.key_value_set(f"{watchdog._KV_PREFIX}/hb/1", "1", True)
    kv.key_value_set(f"{watchdog._KV_PREFIX}/phase/1", "psum", True)
    wd.start()
    _wait_for(lambda: exits)
    assert exits == [watchdog.WATCHDOG_EXIT_CODE]
    evidence = jstatus.read_workload_results()["distributed"]
    assert evidence["ok"] is False
    assert evidence["fault"]["type"] == "peer-heartbeat-lost"
    assert evidence["fault"]["dead_members"][0]["process_id"] == 1
    assert evidence["fault"]["dead_members"][0]["phase"] == "psum"


def test_watchdog_transient_phase_read_failure_defers_verdict(validation_root):
    """A transient error reading a stalled peer's phase defers the verdict
    (the read cannot rule out clean completion); once the read works, the
    non-terminal phase is a death."""

    class _FlakyPhaseKV(_FakeKV):
        flaky = True

        def key_value_try_get(self, key):
            if "/phase/" in key and self.flaky:
                raise RuntimeError("UNAVAILABLE: transient error")
            return super().key_value_try_get(key)

    kv, exits = _FlakyPhaseKV(), []
    wd = _watchdog(kv, exits)
    kv.key_value_set(f"{watchdog._KV_PREFIX}/hb/1", "1", True)
    kv.key_value_set(f"{watchdog._KV_PREFIX}/phase/1", "psum", True)
    wd.start()
    time.sleep(0.3)
    assert exits == []
    kv.flaky = False
    _wait_for(lambda: exits)
    wd.stop()
    assert exits == [watchdog.WATCHDOG_EXIT_CODE]


def test_one_store_hiccup_is_not_a_dead_coordinator(validation_root):
    """One failed beat is not a dead coordinator (``_kv_failed``); failures
    that persist past the timeout are, named as member 0."""

    class _FailingKV(_FakeKV):
        failing = 0  # beats left to fail; -1: forever

        def key_value_set(self, key, value, overwrite=True):
            if "/hb/0" in key and self.failing:
                self.failing -= 1 if self.failing > 0 else 0
                raise RuntimeError("UNAVAILABLE: store down")
            super().key_value_set(key, value, overwrite)

    kv, exits = _FailingKV(), []
    wd = watchdog.PeerWatchdog(kv, 0, 2, timeout=0.2, interval=0.01, exit_fn=exits.append)
    wd.start()
    kv.failing = 1
    for _ in range(20):  # keep the peer beating
        kv.key_value_set(f"{watchdog._KV_PREFIX}/hb/1", str(time.monotonic()), True)
        time.sleep(0.02)
    assert exits == []
    kv.failing = -1
    _wait_for(lambda: exits)
    wd.stop()
    assert exits == [watchdog.WATCHDOG_EXIT_CODE]
    fault = jstatus.read_workload_results()["distributed"]["fault"]
    assert fault["type"] == "coordinator-unreachable"
    assert fault["dead_members"] == [{"process_id": 0, "phase": None}]


def test_stopped_watchdog_never_fails_a_finished_host(validation_root):
    kv, exits = _FakeKV(), []
    wd = _watchdog(kv, exits)
    wd.start()
    wd.stop()
    wd._fail_peers([{"process_id": 1}])
    assert exits == []


def test_phase_record_survives_in_the_dropbox(validation_root):
    """set_phase publishes the phase to peers and keeps the in-flight record
    beside the previous run's figures."""
    jstatus.write_workload_results({"distributed": {"ok": True, "losses": [1.0]}})
    kv = _FakeKV()
    wd = watchdog.PeerWatchdog(kv, 1, 2, timeout=5.0)
    wd.set_phase("burn-in")
    assert kv.store[f"{watchdog._KV_PREFIX}/phase/1"] == "burn-in"
    results = jstatus.read_workload_results()
    assert results["distributed"] == {"ok": True, "losses": [1.0]}
    assert results["distributed_inflight"]["phase"] == "burn-in"
    assert results["distributed_inflight"]["process_id"] == 1


def test_store_adapter_on_a_real_store():
    """``StoreKV`` over a TCPStore: set, get, a missing key raises with
    NOT_FOUND and does not block, and the watchdog's own connection sees
    what another client set."""
    import datetime

    import torch.distributed as dist

    port = distributed.free_ports(1)[0]
    master = dist.TCPStore("127.0.0.1", port, is_master=True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=10))
    kv = watchdog.StoreKV.connect("127.0.0.1", port, timeout_s=2.0)
    kv.key_value_set("tpuop/watchdog/hb/0", "7", True)
    assert kv.key_value_try_get("tpuop/watchdog/hb/0") == "7"
    assert master.get("tpuop/watchdog/hb/0") == b"7"
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="NOT_FOUND"):
        kv.key_value_try_get("tpuop/watchdog/hb/1")
    assert time.monotonic() - t0 < 1.0
    master.set("tpuop/watchdog/phase/1", "moe")
    assert watchdog.PeerWatchdog(kv, 0, 2)._peer_phase(1) == "moe"
    assert watchdog.PeerWatchdog(kv, 0, 3)._peer_phase(2) is None
