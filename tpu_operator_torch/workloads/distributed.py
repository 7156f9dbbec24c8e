"""Multi-host distributed validation on PyTorch:
``python -m tpu_operator_torch.workloads.distributed``.  Port of
``tpu_operator/workloads/distributed.py``.

A slice of several hosts is healthy only if all of its hosts can run one
program across every card.  This module is that program, the command of
the per-host validation pods the validator spawns.  A "process" of the
reference is a host here: one pod, with all of that host's cards.

Topology.  The pod's process starts one rank per local card: it is local
rank 0 itself and spawns the others.  Each host publishes its local rank
count in the rendezvous store, so host ``i``'s ranks start after every rank
of the hosts before it: global rank = PROCESS_ID x local + local rank when
the hosts are alike, and world = NUM_PROCESSES x local.  The store is a
``torch.distributed.TCPStore`` at COORDINATOR_ADDRESS, hosted by process
0's local rank 0; the store's connection and ``init_process_group`` are
bounded by DIST_INIT_TIMEOUT_S.  NCCL joins the cards, gloo the CPU ranks.
On a card the local rank count is ``torch.cuda.device_count()``; on the
CPU (``TORCH_DEVICE=cpu``) it is DIST_CPU_RANKS, the counterpart of the
reference's ``--xla_force_host_platform_device_count``.

The phases run in the reference's order, in the one global process group,
through the single-host checks' rank bodies: device-check, psum (every rank
contributes PROCESS_ID + 1), allreduce, ring, burn-in (a (dp, mp) mesh over
the global world), ring-attention (the plain ring, as in the reference),
moe, done.  Only the host process publishes phases and prints JSON.

Failure is bounded, never waited out: a dead peer host is found by the
``PeerWatchdog`` (its own store connection), a failed local rank by the
host's rank monitor; both write evidence, print it last and hard-exit after
killing this host's ranks.  Each rank also holds a parent-death signal
(``prctl(PR_SET_PDEATHSIG, SIGKILL)``), so a host that is SIGKILLed takes
its ranks with it.

Env contract (injected by the validator's pod spec):
  COORDINATOR_ADDRESS  host:port of process 0 (headless-Service DNS in-cluster)
  NUM_PROCESSES        slice host count
  PROCESS_ID           this host's worker id (falls back to TPU_WORKER_ID)
  EXPECTED_DEVICES     cards per host the node promised (device-count truth)
  BURN_IN_STEPS        optional, default 3
  WATCHDOG_TIMEOUT_S   peer-death detection bound (default 20; watchdog.py)
  DIST_INIT_TIMEOUT_S  rendezvous-phase bound (default 120)
  ALLREDUCE_SIZE_MB, RING_SIZE_MB, RING_ATTN_SEQ_PER_CHIP,
  MOE_TOKENS_PER_SHARD the phases' sizes (the allreduce 64 MB on a card,
                       16 on the CPU); ALLREDUCE_MIN_GBPS, RING_MIN_GBPS
                       their gates
  RESULTS_SCOPE        drop-box scope
  FAULT_INJECT         test-only: "<phase>:<process_id>" SIGKILLs that
                       host's process at that phase entry
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import os
import signal
import sys
import threading
import time
from multiprocessing.connection import wait
from typing import Optional

import numpy as np

CPU_RANKS_ENV = "DIST_CPU_RANKS"  # the knob collectives.local_world_size reads
_LOCAL_KEY = "tpuop/local"

# the failing host's phase, readable from main()'s exception handler
_LAST_PHASE: Optional[str] = None


def _enter_phase(wd, name: str, process_id: int) -> None:
    """Phase transition: record for post-mortem evidence (watchdog KV +
    drop-box + a stdout line the orchestrator can stream), then the
    fault-injection hook: a killed host must die exactly AT the phase
    boundary the test names, after the transition is already published."""
    global _LAST_PHASE
    _LAST_PHASE = name
    if wd is not None:
        wd.set_phase(name)
    print(json.dumps({"phase": name, "process_id": process_id}), flush=True)
    spec = os.environ.get("FAULT_INJECT", "")
    if spec:
        phase, _, wid = spec.partition(":")
        if phase == name and wid.strip().isdigit() and int(wid) == process_id:
            print(
                json.dumps({"fault_injected": name, "process_id": process_id}),
                flush=True,
            )
            os.kill(os.getpid(), signal.SIGKILL)


def _store(address: str, is_master: bool, timeout_s: float):
    import torch.distributed as dist

    host, _, port = address.rpartition(":")
    return dist.TCPStore(host, int(port), is_master=is_master, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def _layout(store, process_id: int, num_processes: int, local: int, timeout_s: float):
    """Publish this host's local rank count and read every host's: returns
    (this host's first global rank, world size)."""
    keys = [f"{_LOCAL_KEY}/{i}" for i in range(num_processes)]
    store.set(keys[process_id], str(local))
    store.wait(keys, datetime.timedelta(seconds=timeout_s))
    counts = [int(store.get(key)) for key in keys]
    return sum(counts[:process_id]), sum(counts)


def _join_group(store, rank: int, world: int, device, timeout_s: float) -> None:
    import torch.distributed as dist

    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _set_parent_death_signal(parent_pid: int) -> None:
    """SIGKILL this process when the host process that spawned it dies
    (Linux ``prctl(PR_SET_PDEATHSIG)``); exit at once if it already has."""
    import ctypes

    pr_set_pdeathsig = 1
    ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig, signal.SIGKILL)
    if os.getppid() != parent_pid:
        os._exit(1)


def _local_rank_main(parent_pid: int, local_rank: int, spec: dict) -> None:
    """A spawned local rank: join the host's rendezvous as rank
    ``spec['first_rank'] + local_rank`` and run the phases beside it."""
    import torch

    _set_parent_death_signal(parent_pid)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    else:
        torch.set_num_threads(1)
    store = _store(spec["address"], False, spec["init_timeout_s"])
    _join_group(store, spec["first_rank"] + local_rank, spec["world"], device,
                spec["init_timeout_s"])
    _run_checks(None, spec["process_id"], spec["num_processes"], local_rank,
                spec["local"], spec["first_rank"] + local_rank, spec["world"], device,
                spec["steps"], spec["d_model"], spec["d_hidden"])
    import torch.distributed as dist

    dist.destroy_process_group()
    # the host reads this rank's exit code alone: skip the interpreter's
    # teardown of CUDA and NCCL state, which can outlast the host's wait
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


class LocalRanks:
    """This host's spawned ranks (local ranks 1..local-1), and the monitor
    that fails the host, in bounded time, when one of them dies."""

    def __init__(self, spec: dict, scope: str):
        ctx = multiprocessing.get_context("spawn")
        self.process_id, self.scope = spec["process_id"], scope
        self.procs = [
            ctx.Process(target=_local_rank_main, args=(os.getpid(), i, spec),
                        name=f"local-rank{i}", daemon=True)
            for i in range(1, spec["local"])
        ]
        self._stop = threading.Event()
        self._monitor_thread = threading.Thread(target=self._monitor, name="rank-monitor",
                                                daemon=True)

    def start(self) -> None:
        for p in self.procs:
            p.start()
        if self.procs:
            self._monitor_thread.start()

    def _monitor(self) -> None:
        pending = list(self.procs)
        while pending and not self._stop.is_set():
            wait([p.sentinel for p in pending], 0.5)
            failed = [p for p in pending if p.exitcode not in (None, 0)]
            if failed and not self._stop.is_set():
                evidence = {
                    "ok": False,
                    "process_id": self.process_id,
                    "phase": _LAST_PHASE,
                    "error": "; ".join(f"{p.name} exited {p.exitcode}" for p in failed),
                }
                from tpu_operator_torch.validator import status as vstatus

                vstatus.write_workload_results({"distributed": evidence}, scope=self.scope)
                print(json.dumps(evidence), flush=True)
                self.hard_exit(1)
            pending = [p for p in pending if p.exitcode is None]

    def kill(self) -> None:
        self._stop.set()  # the monitor reports deaths, not kills
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5.0)

    def hard_exit(self, code: int) -> None:
        """Kill this host's ranks, then ``os._exit``: the exit path of the
        watchdog and of the monitor, which skips multiprocessing's own."""
        self.kill()
        os._exit(code)

    def finish(self, timeout_s: float) -> list:
        """Wait for the ranks' clean exit; returns the names of those that
        failed or were still running (and are then killed)."""
        self._stop.set()
        if self._monitor_thread.is_alive():
            # one thread reaps the ranks: two racing waitpid calls can leave
            # a rank that has exited looking alive
            self._monitor_thread.join()
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.1, deadline - time.monotonic()))
        bad = [f"{p.name} exited {p.exitcode}" for p in self.procs if p.exitcode != 0]
        self.kill()
        return bad


def run_worker(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    steps: int = 3,
    d_model: int = 128,
    d_hidden: int = 256,
    device=None,
) -> dict:
    """Rendezvous this host's ranks with every other host's, prove the
    global collective, run the checks.  Returns this host's result dict
    with ``ok``."""
    import torch
    import torch.distributed as dist

    from tpu_operator_torch.workloads import collectives, resolve_device

    device = resolve_device(device)
    # one rank per visible card, DIST_CPU_RANKS on the CPU
    local = collectives.local_world_size(device)
    init_timeout = float(os.environ.get("DIST_INIT_TIMEOUT_S", "120") or 120)
    scope = os.environ.get("RESULTS_SCOPE", "")
    if device.type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    elif local > 1:
        torch.set_num_threads(1)  # the host's ranks share its cores
    if num_processes == 1 and local > 1 and not coordinator_address:
        # one host of several ranks: a store of its own on this machine
        coordinator_address = f"127.0.0.1:{free_ports(1)[0]}"
    store, first_rank, world = None, 0, local
    if num_processes > 1 or local > 1:
        store = _store(coordinator_address, process_id == 0, init_timeout)
        first_rank, world = _layout(store, process_id, num_processes, local, init_timeout)
    spec = {"address": coordinator_address, "device": device.type, "local": local,
            "first_rank": first_rank, "world": world, "process_id": process_id,
            "num_processes": num_processes, "init_timeout_s": init_timeout,
            "steps": steps, "d_model": d_model, "d_hidden": d_hidden}
    ranks = LocalRanks(spec, scope)
    wd = None
    try:
        ranks.start()
        # the ranks an orchestrator would have to reap, should this host hang
        print(json.dumps({"process_id": process_id,
                          "local_rank_pids": [p.pid for p in ranks.procs]}), flush=True)
        if store is not None:
            _join_group(store, first_rank, world, device, init_timeout)
        # bounded peer-death detection from here on (watchdog.py): a dead
        # peer or coordinator fails THIS host in ~WATCHDOG_TIMEOUT_S with
        # structured evidence, instead of wedging in a collective
        if num_processes > 1:
            from tpu_operator_torch.workloads.watchdog import (
                DEFAULT_TIMEOUT_S,
                PeerWatchdog,
                StoreKV,
            )

            timeout = float(os.environ.get("WATCHDOG_TIMEOUT_S", str(DEFAULT_TIMEOUT_S))
                            or DEFAULT_TIMEOUT_S)
            host, _, port = coordinator_address.rpartition(":")
            wd = PeerWatchdog(StoreKV.connect(host, int(port), min(5.0, timeout)),
                              process_id, num_processes, timeout=timeout, scope=scope,
                              exit_fn=ranks.hard_exit)
            wd.start()
        result = _run_checks(wd, process_id, num_processes, 0, local, first_rank, world,
                             device, steps, d_model, d_hidden)
        # every rank tears its communicators down together (NCCL's teardown
        # waits for the peers'), and only then do the ranks exit
        if dist.is_initialized():
            dist.destroy_process_group()
        bad = ranks.finish(init_timeout)
        if bad:
            result.update(ok=False, error=f"local ranks failed: {'; '.join(bad)}")
        return result
    finally:
        if wd is not None:
            wd.stop()
        ranks.kill()


def _run_checks(
    wd,
    process_id: int,
    num_processes: int,
    local_rank: int,
    local: int,
    rank: int,
    world: int,
    device,
    steps: int,
    d_model: int,
    d_hidden: int,
) -> dict:
    """The phases on one rank.  Local rank 0 (the host process) publishes
    them; the result is its view, every check's error already the max over
    all ranks."""
    import torch
    import torch.distributed as dist

    from tpu_operator_torch.workloads import collectives, moe, ring_attention

    def enter(name):
        if local_rank == 0:
            _enter_phase(wd, name, process_id)

    t0 = time.perf_counter()
    enter("device-check")

    # -- device-count truth: the validator promised cards per host via
    # EXPECTED_DEVICES; this host must run exactly that many ranks AND the
    # rendezvous processes x that many; a host with dead cards (or a
    # rendezvous that lost a member's ranks) fails here with the counts
    expected_env = os.environ.get("EXPECTED_DEVICES", "")
    devcheck = None
    if expected_env:
        try:
            devcheck = collectives.device_count_check(int(expected_env), num_processes,
                                                      world_size=local, device=device)
        except ValueError:
            # same contract as run_validation: a malformed env surfaces as a
            # structured failure, not a traceback with no evidence
            devcheck = {
                "ok": False,
                "error": f"malformed EXPECTED_DEVICES={expected_env!r}",
            }
    if devcheck is not None and not devcheck["ok"]:
        return {
            "ok": False,
            "process_id": process_id,
            "num_processes": num_processes,
            "global_devices": world,
            "local_devices": local,
            "devices_check": devcheck,
            "error": devcheck.get("error", "device count mismatch"),
            "backend": device.type,
        }

    # -- global psum proof: every rank contributes (id+1); the expected
    # total is only reachable if every link carried its share
    enter("psum")
    contrib = torch.full((1,), float(process_id + 1), device=device)
    if world > 1:
        dist.all_reduce(contrib)
    total = float(contrib)
    # each host holds `local` ranks of value (id+1)
    expected = float(local * sum(range(1, num_processes + 1)))
    psum_ok = total == expected

    # -- allreduce bandwidth over the global world, gated by
    # ALLREDUCE_MIN_GBPS on the backends of ALLREDUCE_GATE_BACKENDS.  On a
    # card 64 MB, 20 all-reduces a chain, best of 3, where the reference
    # runs 16 MB, 5, best of 2: a chain's readback floor is ~0.44 ms on four
    # H100s against ~0.1 ms an all-reduce, so 5 leave the floor near half
    # the chain, the measurement is flagged overhead-dominated, and a
    # flagged number is never gated
    enter("allreduce")
    size_mb, iters, best_of = ("64", 20, 3) if device.type == "cuda" else ("16", 5, 2)
    bench = collectives._allreduce_rank(
        rank, world, device,
        size_mb=float(os.environ.get("ALLREDUCE_SIZE_MB", size_mb)),
        iters=iters, warmup=1, best_of=best_of,
    )
    try:
        min_gbps = float(os.environ.get("ALLREDUCE_MIN_GBPS", "0") or 0)
    except ValueError:
        min_gbps = 0.0
    collectives.apply_allreduce_gate(bench, min_gbps)
    bw_ok = bool(bench["ok"])

    # -- ring exchange: the per-LINK diagnostic (every hop's payload exact;
    # the rate is the slowest link's).  Report-only unless RING_MIN_GBPS
    enter("ring")
    if world > 1:
        values = collectives.ring_payload(world)
        ring = collectives._ring_rank(
            rank, world, device, size_mb=float(os.environ.get("RING_SIZE_MB", "8")),
            iters=2, best_of=2, values=values, distinct_total=float(sum(values)),
        )
    else:
        ring = {"ok": True, "devices": 1, "skipped": "single card: no ring",
                "transport": "hbm-local", "backend": device.type}
    try:
        ring_min = float(os.environ.get("RING_MIN_GBPS", "0") or 0)
    except ValueError:
        ring_min = 0.0
    collectives.apply_ring_gate(ring, ring_min)
    ring_ok = bool(ring["ok"])

    # -- burn-in over the global (dp, mp) mesh: real SGD steps, the mp
    # row-parallel sum and the dp gradient sum across hosts.  The global
    # batch is sized to dp alone and built alike on every rank, each taking
    # its own rows, so any hosts-vs-dp topology tiles
    enter("burn-in")
    dp, _ = collectives._split_dp_mp(world)
    w1, w2 = collectives._burn_in_weights(d_model, d_hidden, 0)
    gx = np.random.default_rng(1).standard_normal((8 * dp, d_model), dtype=np.float32)
    burn = collectives._burn_in_rank(rank, world, device, w1=w1, w2=w2, x=gx, steps=steps)
    losses = burn["losses"]
    finite = all(np.isfinite(v) for v in losses)
    decreasing = len(losses) < 2 or losses[-1] < losses[0]

    # -- ring attention over the global ring: sequence parallelism ACROSS
    # hosts, exact against the single-device reference (so the probe's
    # sequence stays modest: the reference holds the whole of it)
    enter("ring-attention")
    seq = int(os.environ.get("RING_ATTN_SEQ_PER_CHIP", "8")) * world
    qkv = ring_attention.bf16_normals((1, seq, 2, 16))
    ra = ring_attention._ring_rank(
        rank, world, device, qkv=tuple(x.numpy() for x in qkv), causal=True,
        use_kernel=False, tol=2e-2, out_path="",
    )
    ra_ok = bool(ra["ok"])

    # -- expert parallelism across hosts: the dispatch all-to-all crosses
    # EVERY pair of ranks at once, the full-bisection proof the neighbour
    # ring cannot give; exact against the dense reference
    enter("moe")
    ep = moe._moe_rank(
        rank, world, device,
        tokens_per_shard=int(os.environ.get("MOE_TOKENS_PER_SHARD", "16")),
        d_model=16, d_hidden=32, experts_per_shard=1, capacity_factor=2.0, tol=1e-4,
    )
    ep_ok = bool(ep["ok"])

    from tpu_operator_torch.workloads.watchdog import TERMINAL_PHASE

    # publishing the terminal phase BEFORE returning is what lets peers'
    # watchdogs tell "finished and stopped beating" from "died mid-run"
    enter(TERMINAL_PHASE)
    return {
        "ok": (psum_ok and finite and decreasing and bw_ok and ring_ok
               and ra_ok and ep_ok),
        "process_id": process_id,
        "num_processes": num_processes,
        "global_devices": world,
        "local_devices": local,
        "mesh": burn["mesh"],
        "devices_check": devcheck,
        "psum": {"total": total, "expected": expected, "ok": psum_ok},
        "allreduce": {
            k: bench.get(k)
            for k in ("ok", "busbw_gbps", "algbw_gbps", "size_mb", "transport",
                      "overhead_dominated", "min_gbps", "gated", "error")
            if k in bench
        },
        "ring": {
            k: ring.get(k)
            for k in ("ok", "link_gbps", "max_error", "hops",
                      "overhead_dominated", "min_gbps", "gated", "error")
            if k in ring
        },
        "ring_attention": {
            k: ra.get(k)
            for k in ("ok", "seq", "seq_per_chip", "causal", "max_error", "time_s")
            if k in ra
        },
        "moe": {
            k: ep.get(k)
            for k in ("ok", "experts", "tokens", "dropped_fraction",
                      "max_error", "time_s")
            if k in ep
        },
        "losses": losses,
        "time_s": time.perf_counter() - t0,
        "backend": device.type,
    }


def free_ports(n: int) -> list[int]:
    """``n`` distinct ephemeral ports: all sockets bound SIMULTANEOUSLY
    before any is closed, so concurrent rendezvous groups can never be
    handed the same port."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn_local_workers_outcomes(
    num_processes: int,
    devices_per_proc: int,
    steps: int = 2,
    extra_env: Optional[dict] = None,
    timeout: float = 300,
    port: Optional[int] = None,
    device=None,
) -> list[dict]:
    """Spawn ``num_processes`` real host processes of this program on this
    machine against a local coordinator: the one harness behind the
    multi-host tests and the card smoke run (the env contract below is what
    the validator's pod spec injects in-cluster).

    On the CPU each host runs ``devices_per_proc`` gloo ranks; on the cards
    (``device``, default as ``resolve_device``) host ``i`` is given cards
    ``i * devices_per_proc`` up to the next host's through
    CUDA_VISIBLE_DEVICES.  Returns one outcome dict per host: returncode,
    elapsed wall time, the last JSON line it printed (the result or the
    watchdog's evidence) and output tails, WITHOUT asserting success: the
    fault-injection tests need the failing shapes intact.  Callers running
    several groups at once must pre-allocate distinct ``port``s via
    ``free_ports``."""
    import subprocess

    from tpu_operator_torch.workloads import resolve_device, subprocess_pythonpath

    device = resolve_device(device)
    if port is None:
        port = free_ports(1)[0]
    if device.type == "cuda":
        import torch

        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = (visible.split(",") if visible
                 else [str(i) for i in range(torch.cuda.device_count())])
        if len(cards) < num_processes * devices_per_proc:
            raise RuntimeError(f"{num_processes} hosts x {devices_per_proc} cards asked for "
                               f"but {len(cards)} visible")
    procs = []
    for wid in range(num_processes):
        env = {
            **os.environ,
            # hosts re-import the package via -m; see subprocess_pythonpath
            "PYTHONPATH": subprocess_pythonpath(),
            "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "NUM_PROCESSES": str(num_processes),
            "PROCESS_ID": str(wid),
            "BURN_IN_STEPS": str(steps),
        }
        if device.type == "cuda":
            env.pop("TORCH_DEVICE", None)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                cards[wid * devices_per_proc:(wid + 1) * devices_per_proc])
        else:
            env.update(TORCH_DEVICE="cpu", **{CPU_RANKS_ENV: str(devices_per_proc)})
        env.update(extra_env or {})
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "tpu_operator_torch.workloads.distributed"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
        )

    t0 = time.monotonic()
    deadline = t0 + timeout
    # drain every host CONCURRENTLY and stamp each one's own exit time:
    # sequential drains would credit a fast detection with the slowest
    # sibling's wall time, and polling without draining would deadlock a
    # host that filled its pipe buffer
    drained: dict[int, tuple] = {}

    def _drain(wid: int, proc) -> None:
        out, err = proc.communicate()
        drained[wid] = (out, err, round(time.monotonic() - t0, 3))

    threads = [
        threading.Thread(target=_drain, args=(wid, p), daemon=True)
        for wid, p in enumerate(procs)
    ]
    for th in threads:
        th.start()
    outcomes = []
    try:
        for th in threads:
            th.join(timeout=max(0.1, deadline - time.monotonic()))
        for wid, (th, proc) in enumerate(zip(threads, procs)):
            timed_out = th.is_alive()
            if timed_out:
                proc.kill()
                th.join(timeout=10)
            out, err, elapsed = drained.get(
                wid, ("", "", round(time.monotonic() - t0, 3))
            )
            result = None
            for line in reversed((out or "").splitlines()):
                line = line.strip()
                if line.startswith("{"):
                    try:
                        result = json.loads(line)
                        break
                    except json.JSONDecodeError:
                        continue
            outcomes.append({
                "process_id": wid,
                "returncode": proc.returncode,
                "elapsed_s": elapsed,
                "timed_out": timed_out,
                "result": result,
                # the host's own failure, not its stderr: there the
                # watchdog thread's store errors are noise
                "coordinator_loss": _lost_coordinator(result),
                "stdout_tail": (out or "")[-2000:],
                "stderr_tail": (err or "")[-2000:],
            })
    finally:
        # one host failing must not strand the rest blocked on the dead
        # coordinator with unread pipes
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outcomes


def spawn_local_workers(
    num_processes: int,
    devices_per_proc: int,
    steps: int = 2,
    extra_env: Optional[dict] = None,
    timeout: float = 300,
    port: Optional[int] = None,
    device=None,
) -> list[dict]:
    """``spawn_local_workers_outcomes`` for the healthy path: returns each
    host's parsed result JSON; raises AssertionError when a host exits
    non-zero."""
    outcomes = spawn_local_workers_outcomes(
        num_processes, devices_per_proc, steps=steps,
        extra_env=extra_env, timeout=timeout, port=port, device=device,
    )
    results = []
    for o in outcomes:
        assert o["returncode"] == 0, (
            f"distributed host {o['process_id']} failed:\n"
            f"{o['stdout_tail']}\n{o['stderr_tail']}"
        )
        results.append(o["result"])
    return results


# what a store op raises when the coordinator's store has gone: the error a
# host fails with when its main thread lost the coordinator before its
# watchdog named the loss; such a host was a victim, not the fault
_COORDINATOR_LOSS_SIGNATURES = (
    "Did the remote server shutdown or crash?",
)


def _lost_coordinator(result) -> bool:
    error = str(result.get("error", "")) if isinstance(result, dict) else ""
    return any(sig in error for sig in _COORDINATOR_LOSS_SIGNATURES)


def rendezvous_post_mortem(outcomes: list[dict]) -> dict:
    """Classify a fault-injected (or failed) rendezvous run into structured
    evidence: which members died, how each survivor detected the failure
    (own watchdog vs coordinator loss), at which phase, and whether every
    survivor failed in bounded time (nobody burned the full pod budget
    waiting on a dead peer)."""
    workers = []
    directly_dead: set[int] = set()
    named_dead: set[int] = set()
    for o in outcomes:
        rc = o["returncode"]
        result = o.get("result") or {}
        fault = (result.get("fault") or {}) if isinstance(result, dict) else {}
        dead_members = [d.get("process_id") for d in fault.get("dead_members", [])]
        if rc == 0:
            kind = "succeeded"
        elif fault.get("type") == "peer-heartbeat-lost":
            kind = "watchdog-peer-death"
            named_dead.update(m for m in dead_members if m is not None)
        elif fault.get("type") == "coordinator-unreachable":
            kind = "watchdog-coordinator-loss"
            named_dead.add(0)
        elif o.get("coordinator_loss") or _lost_coordinator(result):
            # checked BEFORE the signal branch: a victim of the lost
            # coordinator is not the fault
            kind = "aborted-coordinator-loss"
            named_dead.add(0)
        elif rc is not None and rc < 0 and (
            not o.get("timed_out")
            or '"fault_injected"' in (o.get("stdout_tail") or "")
        ):
            # the injected fault itself (SIGKILL).  A fault-killed host
            # whose drain also crossed the harness deadline is still a
            # direct death (its fault_injected stdout marker proves it), so
            # dead_members cannot under-report on a slow box.  But a harness
            # kill of a host that merely HUNG (timed_out, no marker) is not
            # a death to attribute survivors' exits to.
            kind = "killed"
            directly_dead.add(o["process_id"])
        else:
            kind = "failed"
        workers.append({
            "process_id": o["process_id"],
            "outcome": kind,
            "returncode": rc,
            "elapsed_s": o.get("elapsed_s"),
            "timed_out": bool(o.get("timed_out")),
            "phase": result.get("phase") if isinstance(result, dict) else None,
            "dead_members": dead_members or None,
        })
    survivors = [w for w in workers if w["outcome"] != "killed"]
    dead = sorted(directly_dead | named_dead)
    return {
        "ok": all(w["outcome"] == "succeeded" for w in workers),
        "workers": workers,
        "dead_members": dead,
        # bounded = every survivor exited by itself (nonzero, not our
        # harness kill at the deadline): the detection worked
        "survivors_failed_bounded": (
            all(not w["timed_out"] and w["returncode"] != 0 for w in survivors)
            if dead else None
        ),
        "max_survivor_elapsed_s": max(
            (w["elapsed_s"] for w in survivors), default=0.0
        ),
    }


def main() -> int:
    from tpu_operator_torch.obs import flight
    from tpu_operator_torch.validator import status as vstatus

    coordinator = os.environ.get("COORDINATOR_ADDRESS", "")
    num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = int(
        os.environ.get("PROCESS_ID", os.environ.get("TPU_WORKER_ID", "0") or "0")
    )
    steps = int(os.environ.get("BURN_IN_STEPS", "3"))
    scope = os.environ.get("RESULTS_SCOPE", "")
    if num_processes > 1 and not coordinator:
        print(json.dumps({"ok": False, "error": "COORDINATOR_ADDRESS required"}))
        return 1
    # flight record beside the results drop-box (the pod mounts that dir)
    recorder = flight.recorder_for(vstatus.flight_record_path(scope))
    with flight.activate(recorder):
        try:
            result = run_worker(coordinator, num_processes, process_id, steps=steps)
        except Exception as e:  # noqa: BLE001 — the exit code IS the validation verdict
            evidence = {
                "ok": False,
                "process_id": process_id,
                # the phase names WHERE the failure hit (e.g. a collective
                # erroring because its peer died): the post-mortem evidence
                "phase": _LAST_PHASE,
                "error": str(e),
            }
            print(json.dumps(evidence), flush=True)
            vstatus.write_workload_results({"distributed": evidence}, scope=scope)
            return 1
        flight.record_result("distributed", result)
    print(json.dumps(result), flush=True)
    # node-local drop-box for the validator -> node-status exporter -> alerts;
    # RESULTS_SCOPE keeps cross-slice figures from overwriting the slice's
    vstatus.write_workload_results({"distributed": result}, scope=scope)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
