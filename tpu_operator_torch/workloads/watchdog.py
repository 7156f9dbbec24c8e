"""Bounded-time failure detection for the multi-host rendezvous.  Port of
``tpu_operator/workloads/watchdog.py``.

A host whose peer died is not told so in bounded time by the runtime: NCCL
blocks inside a collective whose peer is gone until the process group's own
timeout, and with no structured evidence of who died.  This watchdog bounds
that from Python.  Every host publishes a monotonically increasing heartbeat
into the rendezvous' key-value store (a ``torch.distributed.TCPStore``; its
ops need only the store's host alive, not the peer), and a daemon thread
checks the peers' beats.  A peer whose beat stalls past ``timeout`` is
declared dead: the watchdog writes structured evidence (which member died,
which phase it and we were in, detection latency) to the node-local
drop-box, prints it as the final stdout line, and hard-exits with
``WATCHDOG_EXIT_CODE`` (``os._exit`` fires even while the main thread is
wedged inside a collective).  Detection latency is bounded by ``timeout +
interval``.

The store's host (host 0, the coordinator) dying shows as store ops that
keep failing: past ``timeout`` that is ``coordinator-unreachable``; one
transient failure is not.  The watchdog also keeps an in-flight phase record
in the drop-box at every phase transition, the evidence that survives this
host's own death.  ``rendezvous_post_mortem`` (``workloads/distributed.py``)
classifies the shapes from the hosts' outcomes.

The multi-host program passes an ``exit_fn`` that kills this host's rank
processes before ``os._exit`` (``distributed.LocalRanks.hard_exit``): the
hard exit skips multiprocessing's own handlers, and NCCL ranks left alive
would hold the cards.

The watchdog logic is the reference's; only the store differs.
``StoreKV`` gives a ``TCPStore`` the reference client's two calls.  The
watchdog must have a store connection of its own (``StoreKV.connect``): the
main thread's may sit inside a store wait.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import threading
import time
from typing import Optional

_KV_PREFIX = "tpuop/watchdog"

# distinct exit code so orchestrators can tell "this host's watchdog
# detected a dead PEER" from "this host itself failed its checks" (1)
WATCHDOG_EXIT_CODE = 3

DEFAULT_TIMEOUT_S = 20.0

# the phase a host publishes after its last check completes
# (workloads/distributed.py run_worker); a peer parked here has exited
# CLEANLY: its heartbeat stopping is success, not death
TERMINAL_PHASE = "done"


class StoreKV:
    """The coordination-service client's two key-value calls on a
    ``torch.distributed.Store``: ``key_value_try_get`` of a missing key
    raises an error whose text holds ``NOT_FOUND``, as the reference's
    client does, and never blocks on the key."""

    def __init__(self, store):
        self.store = store

    @classmethod
    def connect(cls, host: str, port: int, timeout_s: float = 5.0) -> "StoreKV":
        """A client connection of its own to the store at host:port, its ops
        bounded by ``timeout_s``."""
        import torch.distributed as dist

        return cls(dist.TCPStore(host, port, is_master=False,
                                 timeout=datetime.timedelta(seconds=timeout_s)))

    def key_value_set(self, key: str, value: str, overwrite: bool = True) -> None:
        # a TCPStore set always overwrites, which is all the watchdog asks
        self.store.set(key, value)

    def key_value_try_get(self, key: str) -> str:
        if not self.store.check([key]):
            raise KeyError(f"NOT_FOUND: {key}")
        return self.store.get(key).decode()


class PeerWatchdog:
    """Heartbeat-based peer liveness for one rendezvous.

    ``client`` has ``key_value_set`` and ``key_value_try_get`` (``StoreKV``
    over the rendezvous store), so the watchdog can only start after the
    store is up; the rendezvous before it is bounded by its own timeout.
    """

    def __init__(
        self,
        client,
        process_id: int,
        num_processes: int,
        *,
        timeout: float = DEFAULT_TIMEOUT_S,
        interval: Optional[float] = None,
        scope: str = "",
        exit_fn=os._exit,
    ):
        self.client = client
        self.process_id = process_id
        self.num_processes = num_processes
        self.timeout = timeout
        self.interval = interval if interval else max(0.25, min(2.0, timeout / 8))
        self.scope = scope
        self.exit_fn = exit_fn
        self.phase = "post-init"
        self._beat = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = 0.0
        # peer -> (last value, monotonic time the value last advanced)
        self._last_seen: dict[int, tuple[str, float]] = {}
        # monotonic time KV ops started failing (None while healthy): one
        # transient store hiccup must not be declared a dead coordinator
        self._kv_failing_since: Optional[float] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._started = time.monotonic()
        self._publish_beat()
        self._thread = threading.Thread(
            target=self._run, name="peer-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)

    def set_phase(self, name: str) -> None:
        """Record the phase the main thread is entering.  The KV publish
        lets PEERS name our phase in their evidence; the drop-box write is
        the record that survives our own death (SIGKILL)."""
        self.phase = name
        self._write_inflight()
        try:
            self.client.key_value_set(
                f"{_KV_PREFIX}/phase/{self.process_id}", name, True
            )
        except Exception as e:  # noqa: BLE001 — phase is evidence, not control flow
            logging.getLogger("tpu_operator_torch.watchdog").debug(
                "phase KV publish failed (drop-box record still holds): %s", e
            )

    # ------------------------------------------------------------------
    def _publish_beat(self) -> None:
        self._beat += 1
        self.client.key_value_set(
            f"{_KV_PREFIX}/hb/{self.process_id}", str(self._beat), True
        )

    # sentinel: the phase READ failed (transient KV error), distinct from
    # "peer never published a phase" (None); a cycle that cannot rule out
    # clean completion must not declare death
    _PHASE_UNKNOWN = object()

    def _peer_phase(self, peer: int):
        try:
            return self.client.key_value_try_get(f"{_KV_PREFIX}/phase/{peer}")
        except Exception as e:  # noqa: BLE001
            return None if "NOT_FOUND" in str(e) else self._PHASE_UNKNOWN

    def _write_inflight(self) -> None:
        from tpu_operator_torch.validator import status as vstatus

        # read-modify-write: the drop-box write is a wholesale file replace
        # (status.py), and the exporter may scrape mid-run: the previous
        # run's 'distributed' figures must survive alongside the in-flight
        # phase record, not vanish at the first phase transition
        existing = vstatus.read_workload_results(scope=self.scope) or {}
        existing.pop("ts", None)
        existing["distributed_inflight"] = {
            "process_id": self.process_id,
            "num_processes": self.num_processes,
            "phase": self.phase,
            "elapsed_s": round(time.monotonic() - self._started, 3)
            if self._started
            else 0.0,
        }
        vstatus.write_workload_results(existing, scope=self.scope)

    # ------------------------------------------------------------------
    def _kv_failed(self, now: float, err: Exception) -> bool:
        """Record a failed KV cycle; True once failures have persisted past
        ``timeout`` (the store is served by the coordinator, so persistent
        failure means the coordinator is gone, but ONE transient hiccup
        under load must not fail a healthy host)."""
        if self._kv_failing_since is None:
            self._kv_failing_since = now
        return now - self._kv_failing_since > self.timeout

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            now = time.monotonic()
            try:
                self._publish_beat()
            except Exception as e:  # noqa: BLE001
                if self._kv_failed(now, e):
                    self._fail_coordinator(e)
                    return
                continue
            kv_healthy = True
            dead: list[dict] = []
            for peer in range(self.num_processes):
                if peer == self.process_id:
                    continue
                value = None
                try:
                    value = self.client.key_value_try_get(
                        f"{_KV_PREFIX}/hb/{peer}"
                    )
                except Exception as e:  # noqa: BLE001
                    if "NOT_FOUND" not in str(e):
                        kv_healthy = False
                        if self._kv_failed(now, e):
                            self._fail_coordinator(e)
                            return
                        continue
                    # not published yet: stale-since = watchdog start
                prev = self._last_seen.get(peer)
                if value is not None and (prev is None or prev[0] != value):
                    self._last_seen[peer] = (value, now)
                    continue
                stale_since = prev[1] if prev else self._started
                stale_for = now - stale_since
                if stale_for > self.timeout:
                    phase = self._peer_phase(peer)
                    if phase == TERMINAL_PHASE or phase is self._PHASE_UNKNOWN:
                        # cleanly-exited peer: it published 'done' before its
                        # heartbeat stopped.  A survivor still mid-run must
                        # not hard-kill its own healthy validation over a
                        # finished sibling; and when the phase read itself
                        # failed transiently, this cycle cannot rule clean
                        # completion out, so the verdict waits for the next
                        # healthy read.
                        continue
                    dead.append(
                        {
                            "process_id": peer,
                            "stale_for_s": round(stale_for, 3),
                            "phase": phase,
                        }
                    )
            if kv_healthy:
                self._kv_failing_since = None
            if dead:
                self._fail_peers(dead)
                return

    # ------------------------------------------------------------------
    def _fail_peers(self, dead: list[dict]) -> None:
        self._die(
            {
                "type": "peer-heartbeat-lost",
                "dead_members": dead,
                "timeout_s": self.timeout,
            }
        )

    def _fail_coordinator(self, err: Exception) -> None:
        self._die(
            {
                "type": "coordinator-unreachable",
                "dead_members": [{"process_id": 0, "phase": None}],
                "error": str(err)[:500],
            }
        )

    def _die(self, fault: dict) -> None:
        # a thread that outlived stop()'s bounded join (wedged in a store op
        # that later failed) must never fail a host whose validation already
        # completed: the success result is written by then, and exiting 3
        # would flip a passed run to failed
        if self._stop.is_set():
            return
        evidence = {
            "ok": False,
            "process_id": self.process_id,
            "num_processes": self.num_processes,
            "phase": self.phase,
            "detected_after_s": round(time.monotonic() - self._started, 3),
            "fault": fault,
            "error": (
                f"watchdog: {fault['type']} "
                f"(members {[d['process_id'] for d in fault['dead_members']]}) "
                f"during phase {self.phase!r}"
            ),
        }
        from tpu_operator_torch.validator import status as vstatus

        vstatus.write_workload_results({"distributed": evidence}, scope=self.scope)
        print(json.dumps(evidence), flush=True)
        sys.stdout.flush()
        self.exit_fn(WATCHDOG_EXIT_CODE)
