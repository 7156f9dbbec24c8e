"""The node validator's components on an NVIDIA node: port of
``tpu_operator/validator/components.py``.

The chain and its contract are the reference's: the component names, the
``<component>-ready`` files and their payload keys, the workload pods' names,
env and mounts, the drop-box scopes and the owner DaemonSet stay as they
are, so the unchanged operator, status exporter and DaemonSet templates
read what this validator writes.  What changes is the hardware truth:

  libtpu   — the NVIDIA driver: wait for the driver container's marker (or
             a host-installed driver), then the driver library
             (``libcuda.so.1``) and the cards' ``/dev/nvidia<N>`` nodes
  pjrt     — the CUDA runtime initializes, and sees as many cards as the
             host has device nodes
  plugin   — the node advertises ``nvidia.com/gpu``; optionally a one-card
             vector-add workload pod through the scheduler
  jax      — the readiness gate: vector-add (kernel B1), allreduce and, on
             several cards, the burn-in, in-process or as a spawned
             workload pod running ``tpu_operator_torch.workloads.
             run_validation``
  perf     — the post-ready probes, report-only
  vfio-pci — passthrough chain: vfio group device nodes present

A member of a multi-host slice keeps the reference's slice identity (the
GKE nodepool, topology and accelerator labels, the worker-id labels), so
the unchanged operator names the same slices.  Its gate is one program
across every host of the slice: a headless Service and one pod per host,
pinned to it, running ``tpu_operator_torch.workloads.distributed`` (one
rank per card, NCCL between the hosts), its evidence keyed to a validation
epoch; a declared multislice group adds one such run across its slices.
The hosts talk through their NICs, so the floors there derive from the
host NIC rate (``k8s/nodeinfo.py``).
"""

from __future__ import annotations

import asyncio
import calendar
import copy
import functools
import hashlib
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from tpu_operator_torch import consts, hw
from tpu_operator_torch.k8s.client import ApiClient, ApiError
from tpu_operator_torch.obs import trace
from tpu_operator_torch.validator import status

log = logging.getLogger("tpu_operator_torch.validator")

WORKLOAD_COMMAND = ["python", "-m", "tpu_operator_torch.workloads.run_validation"]
DISTRIBUTED_COMMAND = ["python", "-m", "tpu_operator_torch.workloads.distributed"]
COORDINATOR_PORT = 8476  # the rendezvous store (worker 0's pod)
EPOCH_LABEL = "tpu.google.com/validation-epoch"
# distinct name base for the cross-slice rendezvous: a nodepool whose name
# happens to match a prefixed group key must never share Service or pod
# names (and so epoch tombstones) with it
MULTISLICE_BASE = "tpu-ms-validation"
VALIDATED_EPOCH_ANNOTATION = "tpu.google.com/validated-epoch"

# Fractions of the card's data-sheet NVLink figures the gates require
# (``k8s/nodeinfo.py`` derives the ceilings): the reference's values.
ALLREDUCE_GATE_FRACTION = 0.25
RING_GATE_FRACTION = 0.25
# of the host's NIC line rate, for traffic between the slices of a multislice
DCN_GATE_FRACTION = 0.1


def _env_floor(env_var: str, fallback) -> float:
    """The one bandwidth-floor resolution rule: an explicit env override
    wins — including an explicit 0, which keeps the gate report-only;
    malformed values log and fall through to the ``fallback`` derivation."""
    env = os.environ.get(env_var, "")
    if env != "":
        try:
            return max(0.0, float(env))
        except ValueError:
            log.warning("ignoring malformed %s=%r", env_var, env)
    return fallback()


def _ring_min_gbps(generation: str) -> float:
    """The per-link ring floor for this card, from the catalogue's per-link
    NVLink rate (aggregate / links)."""
    from tpu_operator_torch.k8s.nodeinfo import generation_info

    return _env_floor(
        "RING_MIN_GBPS",
        lambda: round(generation_info(generation).nvlink_link_gbps * RING_GATE_FRACTION, 1),
    )


def _allreduce_min_gbps(generation: str, cards: int) -> float:
    """The armed allreduce gate for ``cards`` cards of this generation, in
    the port's ``busbw_gbps`` convention (the global buffer: ``cards`` times
    NCCL-tests' busbw, whose ceiling is one direction of the card's NVLink,
    nvlink_gbps / 2; ``k8s/nodeinfo.py`` has the derivation)."""
    from tpu_operator_torch.k8s.nodeinfo import generation_info

    return _env_floor(
        "ALLREDUCE_MIN_GBPS",
        lambda: round(
            generation_info(generation).nvlink_gbps / 2 * cards * ALLREDUCE_GATE_FRACTION, 1),
    )


def _slice_min_gbps(generation: str, cards: int) -> float:
    """The armed allreduce gate of a multi-host slice of ``cards`` cards in
    all: the reference's slice fraction of ``cards`` x the host NIC rate,
    the ceiling of NCCL's ring between hosts in the port's ``busbw_gbps``
    convention (``k8s/nodeinfo.py`` has the derivation).  ALLREDUCE_MIN_GBPS
    overrides; an unknown generation keeps it report-only."""
    from tpu_operator_torch.k8s.nodeinfo import generation_info

    return _env_floor(
        "ALLREDUCE_MIN_GBPS",
        lambda: round(generation_info(generation).nic_gbps * cards * ALLREDUCE_GATE_FRACTION, 1),
    )


def _multislice_min_gbps(generation: str = "") -> float:
    """The cross-slice floor, the reference's rule on the catalogue's host
    NIC rate, with no card count (unknown generations keep it report-only;
    MULTISLICE_MIN_GBPS overrides either way)."""
    from tpu_operator_torch.k8s.nodeinfo import generation_info

    return _env_floor(
        "MULTISLICE_MIN_GBPS",
        lambda: round(generation_info(generation).nic_gbps * DCN_GATE_FRACTION, 1),
    )


def _measured_from_results(results: Optional[dict]) -> dict:
    """Map the workload drop-box (a run_validation ``{'checks': {...}}`` or
    a distributed ``{'distributed': {...}}`` shape) to the payload keys the
    node-status exporter serves.  Measurements flagged overhead-dominated
    are dropped (a flagged number cannot be trusted in either direction);
    gate floors are configuration and always pass through."""
    out: dict = {}
    if not isinstance(results, dict):
        return out
    checks = results.get("checks") or {}
    dist = results.get("distributed") or {}
    allreduce = checks.get("allreduce") or dist.get("allreduce") or {}
    ring = checks.get("ring") or dist.get("ring") or {}
    matmul = checks.get("matmul") or {}
    hbm = checks.get("hbm") or {}
    hbm_dma = checks.get("hbm-dma") or {}

    def _num(value):
        return (
            value
            if isinstance(value, (int, float)) and not isinstance(value, bool)
            else None
        )

    def _measured(source: dict, key: str):
        return None if source.get("overhead_dominated") else _num(source.get(key))

    algbw = _measured(allreduce, "algbw_gbps")
    if algbw is None and not allreduce.get("overhead_dominated"):
        # explicit None check, not `or`: a measured 0.0 must survive
        algbw = _num(allreduce.get("busbw_gbps"))
    for key, value in (
        ("algbw_gbps", algbw),
        ("allreduce_min_gbps", _num(allreduce.get("min_gbps"))),
        ("ring_link_gbps", _measured(ring, "link_gbps")),
        ("ring_min_gbps", _num(ring.get("min_gbps"))),
        ("matmul_tflops", _measured(matmul, "tflops")),
        ("mfu", _measured(matmul, "mfu")),
        ("hbm_gbps", _measured(hbm, "gbps")),
        ("hbm_fraction_of_peak", _measured(hbm, "fraction_of_peak")),
        ("hbm_dma_gbps", _measured(hbm_dma, "gbps")),
    ):
        if value is not None:
            out[key] = value
    return out


# measured metric keys compared round-over-round; the gate floors are
# configuration and never "regress"
_REGRESSION_KEYS = (
    "algbw_gbps",
    "ring_link_gbps",
    "matmul_tflops",
    "mfu",
    "hbm_gbps",
    "hbm_dma_gbps",
)


def _regression_threshold() -> float:
    """Relative drop that counts as a regression; PERF_REGRESSION_THRESHOLD
    overrides the 7% default (an explicit 0 flags every drop)."""
    return _env_floor("PERF_REGRESSION_THRESHOLD", lambda: 0.07)


def _regressions_vs_prior(payload: dict, prior: dict) -> list[dict]:
    """Gated metrics that regressed against the previous round's payload."""
    from tpu_operator_torch.workloads import timing

    threshold = _regression_threshold()
    out = []
    for key in _REGRESSION_KEYS:
        verdict = timing.regression_verdict(
            payload.get(key), prior.get(key), threshold=threshold
        )
        if verdict is not None and verdict["verdict"] == "regressed":
            out.append({"metric": key, **verdict})
    return out


def _worker_id_of(node: dict) -> int:
    """The node's slice worker id; raises ValidationError on a malformed or
    missing label (collapsing to 0 would collide with the real worker 0:
    duplicate pod names, a wrong PROCESS_ID in the rendezvous)."""
    from tpu_operator_torch.k8s import nodeinfo

    name, raw = nodeinfo.node_name(node), nodeinfo.worker_id(node)
    if raw == "":
        raise ValidationError(
            f"node {name} is in a multi-host slice but has no worker-id label"
        )
    try:
        wid = int(raw)
    except ValueError:
        raise ValidationError(
            f"node {name} has a non-numeric worker-id label {raw!r}"
        ) from None
    if wid < 0:
        raise ValidationError(f"node {name} has negative worker id {wid}")
    return wid


def _allocatable_cards(node: dict) -> int:
    """The node's allocatable nvidia.com/gpu, at least 1 (unreadable: 1)."""
    alloc = (node.get("status") or {}).get("allocatable") or {}
    try:
        return max(1, int(alloc.get(consts.GPU_RESOURCE, "1")))
    except ValueError:
        return 1


def _parse_k8s_ts(value: str) -> Optional[float]:
    """``2026-08-04T12:00:00Z`` → unix seconds (UTC); None when unparsable."""
    try:
        return float(calendar.timegm(time.strptime(value, "%Y-%m-%dT%H:%M:%SZ")))
    except (TypeError, ValueError):
        return None


@dataclass
class ValidatorConfig:
    node_name: str = field(default_factory=lambda: os.environ.get("NODE_NAME", ""))
    namespace: str = field(
        default_factory=lambda: os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "tpu-operator")
    )
    sleep_interval: float = consts.VALIDATOR_SLEEP_SECONDS
    workload_retries: int = consts.VALIDATOR_WORKLOAD_RETRIES
    resource_retries: int = consts.VALIDATOR_RESOURCE_RETRIES
    with_workload: bool = field(
        default_factory=lambda: os.environ.get("WITH_WORKLOAD", "").lower() in ("1", "true")
    )
    workload_image: str = field(default_factory=lambda: os.environ.get("WORKLOAD_IMAGE", ""))
    # the device the probes and the in-process checks run on: cuda on a
    # node, cpu in tests
    platform: str = field(
        default_factory=lambda: os.environ.get("TPU_VALIDATOR_PLATFORM", "cuda"))


class ValidationError(Exception):
    pass


class Validator:
    COMPONENTS = ("libtpu", "pjrt", "plugin", "jax", "perf", "vfio-pci")

    def __init__(self, config: Optional[ValidatorConfig] = None,
                 client: Optional[ApiClient] = None):
        self.config = config or ValidatorConfig()
        self._client = client
        self._events = None
        # per-component payload of the previous validation round, stashed
        # by run() before it clears the status file: the left side of the
        # round-over-round regression comparison
        self._prior: dict[str, dict] = {}

    def client(self) -> ApiClient:
        if self._client is None:
            from tpu_operator_torch.k8s.client import Config

            self._client = ApiClient(Config.from_env())
        return self._client

    def events(self):
        """Lazy EventRecorder (Events are evidence; posting never gates)."""
        if self._events is None:
            from tpu_operator_torch.obs.events import EventRecorder

            self._events = EventRecorder(
                self.client(), self.config.namespace, component="tpu-validator"
            )
        return self._events

    def _device(self):
        """The device of the in-process checks and probes, with no fallback:
        ``cuda`` with no card visible fails the component."""
        from tpu_operator_torch.workloads import resolve_device

        try:
            return resolve_device(self.config.platform)
        except (RuntimeError, ValueError) as e:
            raise ValidationError(str(e)) from None

    async def _finish_measured(
        self, component: str, payload: dict, scope: str = ""
    ) -> None:
        """Attach the run's flight record to the ready payload and, when a
        gated metric regressed past the threshold against the previous
        round's payload, record it and post a Warning Event — evidence and
        alerting, never a gate."""
        evidence = status.flight_evidence(scope=scope)
        if evidence is not None:
            payload["flight"] = evidence
        prior = self._prior.get(component)
        if not prior:
            return
        regressions = _regressions_vs_prior(payload, prior)
        if not regressions:
            return
        payload["regressions"] = regressions
        if not self.config.node_name:
            return
        from tpu_operator_torch.obs import events as obs_events

        msg = "; ".join(
            f"{r['metric']} {r['prior']:.4g}→{r['current']:.4g}"
            f" ({r['delta_pct']:+.1f}%)"
            for r in regressions
        )
        await self.events().warning(
            obs_events.node_ref(self.config.node_name),
            obs_events.REASON_PERF_REGRESSED,
            f"{component} validation: {msg}",
        )

    # ------------------------------------------------------------------
    async def run(self, component: str) -> None:
        """Run one validation; raises ValidationError on failure."""
        handler = {
            "libtpu": self.validate_libtpu,
            "pjrt": self.validate_pjrt,
            "plugin": self.validate_plugin,
            "jax": self.validate_jax,
            "perf": self.validate_perf,
            "vfio-pci": self.validate_vfio,
        }.get(component)
        if handler is None:
            raise ValidationError(f"invalid component {component!r}; one of {self.COMPONENTS}")
        prior = status.read_status(component)
        if prior is not None:
            self._prior[component] = prior
        status.clear(component)
        with trace.span(f"validate/{component}", kind=trace.KIND_PHASE, phase=component):
            await handler()
        if component == "jax":
            # the join's critical-path segments, strictly after the gate
            # and strictly best-effort
            await self._push_join_phases()

    async def _push_join_phases(self) -> None:
        """One POST of this node's join-phase segments to the metrics agent
        (TPU_METRICS_PUSH_URL), carrying the adopted trace id.  Never
        raises: the join is already proven; this is its breakdown."""
        if not self.config.node_name or not os.environ.get("TPU_METRICS_PUSH_URL"):
            return
        try:
            node = await self.client().get("", "Node", self.config.node_name)
            raw = (node.get("metadata") or {}).get("creationTimestamp", "")
            segments = status.join_phase_segments(_parse_k8s_ts(raw) if raw else None)
            if not segments:
                return
            env_ctx = trace.TraceContext.from_env()
            tid = trace.trace_id() or (env_ctx.trace_id if env_ctx else "")
            from tpu_operator_torch.obs import flight

            await asyncio.get_running_loop().run_in_executor(
                None,
                functools.partial(
                    flight.push_join_phases, self.config.node_name, segments, trace_id=tid,
                ),
            )
        except Exception as e:  # noqa: BLE001 — telemetry must never fail a gate
            log.debug("join-phase push failed: %s", e)

    async def wait_ready(self, component: str, retries: Optional[int] = None) -> None:
        """--wait-only: block until another pod's validation wrote the file."""
        retries = retries if retries is not None else self.config.workload_retries
        for _ in range(retries):
            if status.is_ready(component):
                return
            await asyncio.sleep(self.config.sleep_interval)
        raise ValidationError(f"timed out waiting for {component}-ready")

    # ------------------------------------------------------------------
    async def validate_libtpu(self) -> None:
        """Wait for the driver container, then probe the host's truth: the
        driver library and the cards' device nodes."""
        host_managed = False
        for _ in range(self.config.resource_retries):
            if status.marker_exists(consts.LIBTPU_CTR_MARKER):
                break
            if hw.libcuda_path():
                # no operator-managed driver container but the driver is on
                # the host → a host-managed driver
                host_managed = True
                break
            await asyncio.sleep(self.config.sleep_interval)
        else:
            raise ValidationError("NVIDIA driver container never became ready")
        libcuda = hw.libcuda_path()
        if not libcuda:
            raise ValidationError("libcuda.so.1 (the NVIDIA driver) not found on host")
        chips = hw.chip_count()
        if chips <= 0:
            raise ValidationError("no /dev/nvidia<N> card device nodes")
        status.write_ready(
            "libtpu", {"libtpu_path": libcuda, "chips": chips, "host_managed": host_managed}
        )

    async def validate_pjrt(self) -> None:
        """The CUDA runtime initializes and sees every card.  The device
        count must match the host's truth (libtpu-ready's /dev/nvidia<N>
        count): a card the runtime cannot open (fallen off the bus, masked
        out) makes a half-dead host, which must fail here, not pass on the
        survivors."""
        await self.wait_ready("libtpu", retries=self.config.resource_retries)
        platform = self.config.platform

        def probe() -> dict:
            import torch

            if platform == "cuda":
                count = torch.cuda.device_count() if torch.cuda.is_available() else 0
                kind = torch.cuda.get_device_name(0) if count else ""
            elif platform == "cpu":
                from tpu_operator_torch.workloads import collectives

                count, kind = collectives.local_world_size(torch.device("cpu")), "cpu"
            else:
                raise ValidationError(f"unsupported platform {platform!r}: cuda or cpu")
            if not count:
                raise ValidationError(f"the CUDA runtime reports no {platform} devices")
            return {"platform": platform, "device_count": count, "device_kind": kind}

        payload = await asyncio.get_running_loop().run_in_executor(None, probe)
        from tpu_operator_torch.workloads.timing import gate_backends

        chips = (status.read_status("libtpu") or {}).get("chips")
        if (
            platform in gate_backends("DEVICE_COUNT_GATE_BACKENDS")
            and isinstance(chips, int)
            and chips > 0
            and payload["device_count"] != chips
        ):
            raise ValidationError(
                f"the CUDA runtime initialized {payload['device_count']} devices but the "
                f"host has {chips} card device nodes — dead or missing cards"
            )
        payload["host_chips"] = chips
        status.write_ready("pjrt", payload)

    async def validate_plugin(self) -> None:
        """The node advertises nvidia.com/gpu."""
        if not self.config.node_name:
            raise ValidationError("NODE_NAME required for plugin validation")
        client = self.client()
        for _ in range(self.config.resource_retries):
            node = await client.get("", "Node", self.config.node_name)
            alloc = (node.get("status") or {}).get("allocatable") or {}
            try:
                count = int(alloc.get(consts.GPU_RESOURCE, "0"))
            except ValueError:
                count = 0
            if count > 0:
                if self.config.with_workload:
                    await self.spawn_workload(
                        "tpu-plugin-workload-validation", checks="vector-add", tpu_request=1
                    )
                status.write_ready("plugin", {"allocatable": count})
                return
            await asyncio.sleep(self.config.sleep_interval)
        raise ValidationError(
            f"node {self.config.node_name} never advertised {consts.GPU_RESOURCE}")

    async def validate_jax(self) -> None:
        """The readiness gate over every local card: vector-add, allreduce
        and, on several cards, the sharded burn-in; on a multi-host slice,
        one program across every host of the slice."""
        await self.wait_ready("plugin", retries=self.config.resource_retries)
        # fresh flight record for this round: recorders append, so the one
        # per-node coordinator clears stale samples before any writer starts
        status.clear_flight_record()
        if self.config.with_workload:
            group = await self._slice_group()
            if group is not None:
                await self.validate_jax_multihost(*group)
                return
            chips = await self._node_chip_count()
            # several cards: the local allreduce rides NVLink — arm the
            # busbw gate from the catalogue (one card stays report-only)
            min_gbps = 0.0
            if chips > 1:
                from tpu_operator_torch.k8s import nodeinfo

                node = await self.client().get("", "Node", self.config.node_name)
                min_gbps = _allreduce_min_gbps(nodeinfo.generation_of_node(node), chips)
            # the gate is the minimal workload; the probes run post-ready
            # (perf), and the burn-in gates only where it tests collectives
            checks = "vector-add,allreduce" + (",burn-in" if chips > 1 else "")
            await self.spawn_workload(
                "tpu-jax-workload-validation",
                checks=checks,
                tpu_request=chips,
                min_gbps=min_gbps,
            )
            payload = {
                "mode": "workload-pod", "chips": chips,
                "allreduce_min_gbps": min_gbps,
            }
            payload.update(_measured_from_results(status.read_workload_results()))
            await self._finish_measured("jax", payload)
            status.write_ready("jax", payload)
            return

        device = self._device()

        def run_checks() -> dict:
            from tpu_operator_torch.obs import flight
            from tpu_operator_torch.workloads import collectives

            # the same flight record a workload pod would leave, samples
            # under per-check phase spans (explicit activation: executor
            # threads don't inherit the loop's contextvars)
            recorder = flight.recorder_for(status.flight_record_path())
            local_tracer = trace.Tracer()
            with local_tracer.adopt(trace.TraceContext.from_env()), flight.activate(recorder):
                checks = [
                    ("vector-add", lambda: collectives.vector_add(1 << 16, device=device)),
                    (
                        "allreduce",
                        lambda: collectives.allreduce_benchmark(
                            size_mb=4, iters=3, warmup=1, device=device
                        ),
                    ),
                ]
                if collectives.local_world_size(device) > 1:
                    checks.append(
                        ("burn-in", lambda: collectives.burn_in(steps=2, device=device)))
                results = {}
                for name, fn in checks:
                    with trace.span(f"check/{name}", kind=trace.KIND_PHASE, phase=name):
                        results[name] = fn()
                        flight.record_result(name, results[name])
                for name, r in results.items():
                    if not r.get("ok"):
                        raise ValidationError(f"jax check {name} failed: {r}")
            # the same flag filter as the workload path: a flagged number
            # must never reach the exporter
            return {
                "mode": "in-process",
                "devices": results["allreduce"]["devices"],
                **_measured_from_results({"checks": results}),
            }

        payload = await asyncio.get_running_loop().run_in_executor(None, run_checks)
        await self._finish_measured("jax", payload)
        status.write_ready("jax", payload)

    async def validate_perf(self) -> None:
        """Post-ready perf probes: matmul MFU, the HBM stream and its DMA
        cross-check (kernel B2), and on several cards the per-link ring and
        ring attention (kernel B3).  Runs strictly after jax-ready.  Probe
        failures are recorded in perf-ready (ok=false + error), not raised:
        a slow card is the alerts' business, not a reason to mark the node
        unvalidated.  Workload-pod results land in their own drop-box
        scope, so they never clobber the gating run's figures."""
        await self.wait_ready("jax", retries=self.config.resource_retries)
        if self.config.with_workload:
            from tpu_operator_torch.k8s import nodeinfo

            group = await self._slice_group()
            if group is not None:
                # a slice member's cards are proven only inside the slice's
                # one program, which measures its allreduce and ring; a
                # node-local probe pod has no valid run here, so the skip is
                # recorded.  The node-local drop-box clears too: a node that
                # ran probes alone and then joined a slice must not keep
                # exporting stale figures to the alerts
                status.clear_workload_results(scope="perf")
                status.clear_flight_record(scope="perf")
                status.write_ready("perf", {
                    "ok": True,
                    "skipped": "multi-host slice member: node-local PJRT "
                               "init is invalid; slice perf is measured by "
                               "the coordinated multi-host validation",
                    "slice": group[0],
                })
                return
            chips = await self._node_chip_count()
            node = await self.client().get("", "Node", self.config.node_name)
            generation = nodeinfo.generation_of_node(node)
            ring_min = _ring_min_gbps(generation) if chips > 1 else 0.0
            # several cards: the ring diagnostic and the parallelism census;
            # one card: the burn-in moves here from the gate
            checks = "matmul,hbm,hbm-dma,longctx,decode" + (
                ",ring,ring-attention,ulysses,moe,pipeline"
                if chips > 1 else ",burn-in"
            )
            # the CR-level probe budget: a check selection and a time budget
            # forwarded to the probe pod, which stops starting checks past it
            checks = os.environ.get("PERF_PROBE_CHECKS", "") or checks
            budget = _env_floor("PERF_PROBE_BUDGET_S", lambda: 0.0)
            # clear the previous run's drop-box first: a failed probe run
            # must surface as "no current measurements", never republish
            # last round's figures
            status.clear_workload_results(scope="perf")
            status.clear_flight_record(scope="perf")
            ok, error = True, None
            try:
                await self.spawn_workload(
                    "tpu-perf-probes",
                    checks=checks,
                    tpu_request=chips,
                    ring_min_gbps=ring_min,
                    results_scope="perf",
                    budget_seconds=budget,
                )
            except ValidationError as e:
                ok, error = False, str(e)
                # a pod left Pending or Running would later take the cards
                # it never got from user workloads
                await self.client().delete(
                    "", "Pod", "tpu-perf-probes", self.config.namespace
                )
            dropbox = status.read_workload_results(scope="perf") or {}
            results = dropbox.get("checks") or {}
            measured = _measured_from_results(dropbox)
        else:
            device = self._device()

            def run_probes() -> dict:
                from tpu_operator_torch.obs import flight
                from tpu_operator_torch.workloads import (
                    collectives,
                    hbm_bench,
                    hbm_dma,
                    matmul_bench,
                    ring_attention,
                    run_validation,
                )

                multi = collectives.local_world_size(device) > 1
                # the per-link floor is recorded here too; the generation
                # comes from the card's name, no apiserver needed
                ring_min = (
                    _ring_min_gbps(matmul_bench.detect_generation(device)) if multi else 0.0
                )
                # the ring at the probe pod's shipping size on a card, as the
                # other probes run theirs: its hops are host-launched, and at
                # the reference's 2 MB a hop's launch outweighs its bytes
                # (1.8 GB/s per link on four healthy H100 SXM cards, under
                # the 12.5 floor); the reference's in-process size on the CPU
                ring_size = (dict(size_mb=16.0, iters=4, best_of=3) if device.type == "cuda"
                             else dict(size_mb=2, iters=2, best_of=2))
                probes = {
                    "matmul": lambda: matmul_bench.quick_benchmark(device),
                    "hbm": lambda: hbm_bench.quick_benchmark(device),
                    "hbm-dma": lambda: hbm_dma.quick_benchmark(device),
                    "ring": lambda: collectives.apply_ring_gate(
                        collectives.ring_benchmark(**ring_size, device=device), ring_min),
                }
                if multi:
                    # sequence-parallel exact attention over the local ring
                    probes["ring-attention"] = lambda: ring_attention.quick_check(device)
                else:
                    # one card: the burn-in runs here, post-ready
                    probes["burn-in"] = lambda: collectives.burn_in(steps=2, device=device)
                # the CR-level selection and budget apply in-process as in
                # the probe pod
                selected = os.environ.get("PERF_PROBE_CHECKS", "")
                if selected:
                    valid = run_validation.known_checks()
                    names = [c.strip() for c in selected.split(",") if c.strip()]

                    def _unavailable(n):
                        # a valid name this node runs only in the probe pod
                        # is skipped evidence; a typo fails as the pod would
                        if n in valid:
                            return {
                                "ok": True,
                                "skipped": f"probe {n} not available in-process",
                            }
                        return {"ok": False, "error": f"unknown check {n}"}

                    probes = {
                        n: probes.get(n, functools.partial(_unavailable, n))
                        for n in names
                    }
                budget = _env_floor("PERF_PROBE_BUDGET_S", lambda: 0.0)
                t_start = time.monotonic()
                out = {}
                recorder = flight.recorder_for(status.flight_record_path("perf"))
                local_tracer = trace.Tracer()
                with local_tracer.adopt(trace.TraceContext.from_env()), flight.activate(recorder):
                    for probe_name, fn in probes.items():
                        if budget and time.monotonic() - t_start > budget:
                            out[probe_name] = {
                                "ok": True,
                                "skipped": f"budget ({budget}s) exhausted",
                            }
                            continue
                        with trace.span(
                            f"check/{probe_name}", kind=trace.KIND_PHASE, phase=probe_name,
                        ):
                            try:
                                out[probe_name] = fn()
                            except Exception as e:  # noqa: BLE001
                                # post-ready the card is schedulable: a user
                                # pod may hold it — record and move on
                                out[probe_name] = {"ok": False, "error": str(e)}
                            flight.record_result(probe_name, out[probe_name])
                return out

            results = await asyncio.get_running_loop().run_in_executor(None, run_probes)
            ok = all(bool(r.get("ok")) for r in results.values())
            error = None if ok else "; ".join(
                f"{name}: {r.get('error', 'failed')}"
                for name, r in results.items()
                if not r.get("ok")
            )
            measured = _measured_from_results({"checks": results})
        # top level: the filtered measurements the exporter serves;
        # "checks": the raw probe results, flags and all
        payload = {"ok": ok, **measured, "checks": results}
        if error:
            payload["error"] = error
        await self._finish_measured("perf", payload, scope="perf")
        status.write_ready("perf", payload)

    # ------------------------------------------------------------------
    # Multi-host slice validation: one distributed program across hosts.

    async def _slice_group(self) -> Optional[tuple[str, list[dict]]]:
        """(group key, member nodes ordered by worker id) when this node
        belongs to a multi-host slice; None otherwise.  Membership is the
        GKE nodepool (one multi-host slice per pool)."""
        from tpu_operator_torch.k8s import nodeinfo

        if not self.config.node_name:
            return None
        client = self.client()
        node = await client.get("", "Node", self.config.node_name)
        key = nodeinfo.slice_group_key(node)
        if not key:
            return None
        members = (
            nodeinfo.NodeFilter()
            .tpu()
            .eq(consts.GKE_NODEPOOL_LABEL, key)
            .apply(await client.list_items("", "Node"))
        )
        self._checked_worker_ids(key, members)  # sorts members in place
        return key, members

    @staticmethod
    def _checked_worker_ids(key: str, members: list[dict]) -> dict[str, int]:
        """Validate one slice's worker-id labels (numeric, unique, covering
        0..N-1, every host present), sort ``members`` by id in place, and
        return {node name: worker id}."""
        from tpu_operator_torch.k8s import nodeinfo

        ids = {nodeinfo.node_name(m): _worker_id_of(m) for m in members}
        dupes = {i for i in ids.values() if list(ids.values()).count(i) > 1}
        if dupes:
            raise ValidationError(
                f"slice {key}: duplicate worker ids {sorted(dupes)} across hosts "
                f"{sorted(n for n, i in ids.items() if i in dupes)}"
            )
        members.sort(key=lambda m: ids[nodeinfo.node_name(m)])
        expected = max(nodeinfo.slice_hosts(m) for m in members)
        if len(members) < expected:
            raise ValidationError(
                f"slice {key}: only {len(members)}/{expected} hosts present"
            )
        if sorted(ids.values()) != list(range(len(members))):
            raise ValidationError(
                f"slice {key}: worker ids {sorted(ids.values())} do not cover "
                f"0..{len(members) - 1}; check the worker-id labels"
            )
        return ids

    async def _multislice_group(
        self,
    ) -> Optional[tuple[str, list[dict], dict[str, int], dict[str, list[dict]]]]:
        """(group key, members in global order, {node: global process id},
        {slice key: slice members}) when this node's slice belongs to a
        declared multislice group of more than one slice; None otherwise.

        Membership is the ``tpu.google.com/multislice-group`` label; global
        process ids order the slices by key and the hosts by worker id
        within each, so every member derives the same order."""
        from tpu_operator_torch.k8s import nodeinfo

        client = self.client()
        node = await client.get("", "Node", self.config.node_name)
        labels = (node.get("metadata") or {}).get("labels") or {}
        ms_key = labels.get(consts.MULTISLICE_GROUP_LABEL)
        if not ms_key:
            return None
        members = (
            nodeinfo.NodeFilter()
            .tpu()
            .eq(consts.MULTISLICE_GROUP_LABEL, ms_key)
            .apply(await client.list_items("", "Node"))
        )
        slices: dict[str, list[dict]] = {}
        for m in members:
            sk = nodeinfo.slice_group_key(m)
            if not sk:
                raise ValidationError(
                    f"multislice {ms_key}: member {nodeinfo.node_name(m)} has no "
                    "slice identity (single-host or missing nodepool label)"
                )
            slices.setdefault(sk, []).append(m)
        declared = labels.get(consts.MULTISLICE_SLICES_LABEL)
        if declared:
            try:
                expected_slices = int(declared)
            except ValueError:
                raise ValidationError(
                    f"multislice {ms_key}: malformed "
                    f"{consts.MULTISLICE_SLICES_LABEL}={declared!r}"
                ) from None
            if len(slices) != expected_slices:
                # a wholly absent member slice fails, as a partly present
                # slice does: slice health is a property of the whole set
                raise ValidationError(
                    f"multislice {ms_key}: {len(slices)}/{expected_slices} "
                    f"member slices visible ({sorted(slices)})"
                )
        elif len(slices) < 2:
            log.warning(
                "multislice %s: only one member slice visible and no %s "
                "declaration; skipping cross-slice validation (set the label "
                "to make absence a failure)",
                ms_key, consts.MULTISLICE_SLICES_LABEL,
            )
            return None
        ordered: list[dict] = []
        for sk in sorted(slices):
            self._checked_worker_ids(sk, slices[sk])  # sorts by worker id
            ordered.extend(slices[sk])
        ids = {nodeinfo.node_name(m): i for i, m in enumerate(ordered)}
        return ms_key, ordered, ids, slices

    async def _await_member_slices_proven(
        self, ms_key: str, slices: dict[str, list[dict]]
    ) -> None:
        """Hold the cross-slice run until every member slice's own
        rendezvous is proven and garbage-collected (its Service's tombstone
        at the slice's current epoch): a pinned pod that does not fit its
        node's free cards is rejected, not queued, so cross-slice pods must
        not race the member slices' pods for the same cards."""
        for _ in range(self.config.workload_retries):
            pending = None
            for sk, mems in slices.items():
                svc = self._group_service_name(sk)
                epoch = await self._validation_epoch(mems)
                if await self._group_tombstone(svc) != epoch:
                    pending = sk
                    break
            if pending is None:
                return
            await asyncio.sleep(self.config.sleep_interval)
        raise ValidationError(
            f"multislice {ms_key}: member slice {pending} never proved its own "
            "rendezvous; cannot start the cross-slice phase"
        )

    def _group_pod_name(
        self, key: str, worker_id: int, base: str = "tpu-jax-validation"
    ) -> str:
        from tpu_operator_torch.utils import hashed_name

        return hashed_name(base, f"{key}-w{worker_id}")

    def _group_service_name(self, key: str, base: str = "tpu-jax-validation") -> str:
        from tpu_operator_torch.utils import hashed_name

        return hashed_name(base, key)

    async def _validation_epoch(self, members: list[dict]) -> str:
        """Identity of the runtime the slice is proven against.  A pod's
        Succeeded phase is evidence only for the runtime it ran on: the
        epoch hashes, per member, the live runtime pod's UID (new on every
        swap, a same-version reinstall included) with the reported version
        label as the host-managed fallback, so every host derives the same
        value from cluster state."""
        from tpu_operator_torch.k8s import nodeinfo

        runtime_uid: dict[str, str] = {}
        for pod in await self.client().list_items(
            "", "Pod", self.config.namespace, label_selector="app=tpu-runtime"
        ):
            meta = pod.get("metadata") or {}
            if meta.get("deletionTimestamp"):
                continue
            node = (pod.get("spec") or {}).get("nodeName")
            if node:
                runtime_uid[node] = meta.get("uid", "")
        ident = sorted(
            (nodeinfo.node_name(m), runtime_uid.get(nodeinfo.node_name(m), ""),
             nodeinfo.runtime_version(m))
            for m in members
        )
        return hashlib.sha1(json.dumps(ident).encode()).hexdigest()[:12]

    async def validate_jax_multihost(self, key: str, members: list[dict]) -> None:
        """One global collective across every host of the slice.

        Worker 0's validator converges the rendezvous: a headless Service
        and one workload pod per host, pinned to it, running the distributed
        program with the store at worker 0's pod.  Every host's validator
        gates its own ``jax-ready`` on its own pod succeeding, which happens
        only if the global psum, allreduce and burn-in passed on every host.
        Evidence is keyed to a validation epoch: a Succeeded pod of an older
        epoch is stale, and whichever validator notices (worker 0 at once,
        another after a grace period) recreates the out-of-date pods.  After
        success the converging validator records the epoch on the Service
        and deletes the pods, so later validators accept the tombstone.

        When the slice belongs to a declared multislice group, ``jax-ready``
        also needs the cross-slice rendezvous over every host of every
        member slice, with global process ids, gated at the cross-slice
        floor (``_multislice_min_gbps``)."""
        ids = {m["metadata"]["name"]: _worker_id_of(m) for m in members}
        payload = await self._validate_group_rendezvous(
            key, members, ids, mode="multi-host"
        )
        ms = await self._multislice_group()
        if ms is not None:
            ms_key, ms_members, ms_ids, ms_slices = ms
            ms_payload = await self._validate_group_rendezvous(
                ms_key, ms_members, ms_ids, mode="multislice",
                gate_slice=False,
                base=MULTISLICE_BASE,
                # awaited before every convergence, not just the first: an
                # epoch change mid-run re-triggers the member slices'
                # validations, and cross-slice pods must never race them
                before_ensure=functools.partial(
                    self._await_member_slices_proven, ms_key, ms_slices
                ),
            )
            payload["multislice"] = {
                k: ms_payload[k]
                for k in ("group", "workers", "worker_id", "epoch", "proven_by")
            }
            # the cross-slice pods' figures, from their own scope
            payload["multislice"].update(
                _measured_from_results(status.read_workload_results(scope="multislice"))
            )
        # this host's slice pod wrote its figures into the node-local
        # drop-box; on the tombstone path it holds the last run's, the
        # exporter's "last measured"
        payload.update(_measured_from_results(status.read_workload_results()))
        await self._finish_measured("jax", payload)
        status.write_ready("jax", payload)

    async def _validate_group_rendezvous(
        self,
        key: str,
        members: list[dict],
        ids: dict[str, int],
        mode: str,
        gate_slice: bool = True,
        base: str = "tpu-jax-validation",
        before_ensure=None,
    ) -> dict:
        """Converge and gate on one rendezvous over ``members`` with the
        given process ids; returns the proof payload (the caller writes the
        status).  ``base`` namespaces the Service and pod names, so distinct
        rendezvous kinds never share evidence."""
        my_id = ids[self.config.node_name]
        svc = self._group_service_name(key, base)
        coordinator = (
            f"{self._group_pod_name(key, 0, base)}.{svc}."
            f"{self.config.namespace}.svc:{COORDINATOR_PORT}"
        )
        client = self.client()
        epoch = await self._validation_epoch(members)
        if my_id == 0:
            if before_ensure is not None:
                await before_ensure()
            await self._ensure_group_workloads(
                key, members, svc, coordinator, epoch, ids, gate_slice, base
            )

        def ready_payload(proven_by: str) -> dict:
            return {
                "mode": mode,
                "group": key,
                "workers": len(members),
                "worker_id": my_id,
                "epoch": epoch,
                "proven_by": proven_by,
            }

        # the other workers give worker 0 this many polls before converging
        # the pod set themselves (idempotent: current pods are left alone)
        patience = 10 if my_id != 0 else 0
        name = self._group_pod_name(key, my_id, base)
        phase = None
        ensured = my_id == 0  # whoever converged the pod set also collects it
        for attempt in range(self.config.workload_retries):
            # the epoch is derived anew on every poll: validators that kept
            # different snapshots across a runtime restart would delete each
            # other's pod sets until their retries ran out
            epoch = await self._validation_epoch(members)
            if await self._group_tombstone(svc) == epoch:
                return ready_payload("service-tombstone")
            try:
                live = await client.get("", "Pod", name, self.config.namespace)
            except ApiError as e:
                if not e.not_found:
                    raise
                live = None
            pod_epoch = (
                ((live.get("metadata") or {}).get("labels") or {}).get(EPOCH_LABEL)
                if live is not None
                else None
            )
            if live is None or pod_epoch != epoch:
                if attempt >= patience:
                    if before_ensure is not None:
                        await before_ensure()
                    await self._ensure_group_workloads(
                        key, members, svc, coordinator, epoch, ids, gate_slice, base
                    )
                    ensured = True
                await asyncio.sleep(self.config.sleep_interval)
                continue
            phase = (live.get("status") or {}).get("phase")
            if phase == "Succeeded":
                if ensured:
                    # the validator that converged the pod set records the
                    # tombstone and collects the pods, also when a worker
                    # other than 0 drove a re-proof
                    await self._cleanup_group_workloads(
                        key, members, svc, epoch, ids, base
                    )
                return ready_payload("workload-pod")
            if phase == "Failed":
                raise ValidationError(
                    f"distributed validation pod {name} failed (slice {key})"
                )
            await asyncio.sleep(self.config.sleep_interval)
        raise ValidationError(
            f"distributed validation pod {name} did not complete (phase={phase})"
        )

    async def _group_tombstone(self, svc: str) -> Optional[str]:
        """The epoch already proven for this group, recorded on its headless
        Service once the pods were collected."""
        try:
            service = await self.client().get("", "Service", svc, self.config.namespace)
        except ApiError as e:
            if e.not_found:
                return None
            raise
        return ((service.get("metadata") or {}).get("annotations") or {}).get(
            VALIDATED_EPOCH_ANNOTATION
        )

    async def _ensure_group_workloads(
        self,
        key: str,
        members: list[dict],
        svc: str,
        coordinator: str,
        epoch: str,
        ids: dict[str, int],
        gate_slice: bool = True,
        base: str = "tpu-jax-validation",
    ) -> None:
        """Converge the headless Service and one pinned pod per host to the
        current epoch; pods already at it (and not Failed) are left alone.
        ``ids`` gives each host its process id (worker ids in a slice,
        global ids across a multislice).  ``gate_slice`` arms the slice's
        floor; the cross-slice run takes the cross-slice floor instead."""
        from tpu_operator_torch.k8s import nodeinfo

        if await self._group_tombstone(svc) == epoch:
            # already proven and collected (the cleanup can land between a
            # peer's tombstone check and its pod poll): new pods here would
            # start a rendezvous nobody joins
            return
        client = self.client()
        owner = await self._owner_daemonset()
        service = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": svc,
                "namespace": self.config.namespace,
                "labels": {"app": "tpu-jax-validation", "tpu.google.com/slice-group": svc},
            },
            "spec": {
                "clusterIP": "None",  # headless: per-pod DNS for the rendezvous
                "selector": {"tpu.google.com/slice-group": svc},
                "ports": [{"port": COORDINATOR_PORT, "name": "coordinator"}],
            },
        }
        if owner is not None:
            from tpu_operator_torch.k8s.client import set_owner_reference

            set_owner_reference(service, owner)
        try:
            await client.create(service)
        except ApiError as e:
            if not e.already_exists:
                raise
        # the program's world: every host's cards, one rank each
        cards = sum(_allocatable_cards(m) for m in members)
        for member in members:
            node = nodeinfo.node_name(member)
            wid = ids[node]
            name = self._group_pod_name(key, wid, base)
            try:
                live = await client.get("", "Pod", name, self.config.namespace)
            except ApiError as e:
                if not e.not_found:
                    raise
                live = None
            if live is not None:
                current = ((live.get("metadata") or {}).get("labels") or {}).get(EPOCH_LABEL)
                if current == epoch and (live.get("status") or {}).get("phase") != "Failed":
                    continue
                await client.delete("", "Pod", name, self.config.namespace)
            generation = nodeinfo.generation_of_node(member)
            if gate_slice:
                # the armed slice floor, from the host NIC rate; the ring
                # stays report-only across hosts (its hops in enumeration
                # order only bound a link's rate from below) unless
                # RING_MIN_GBPS arms it
                min_gbps = _slice_min_gbps(generation, cards)
                ring_min = _env_floor("RING_MIN_GBPS", lambda: 0.0)
            else:
                min_gbps = _multislice_min_gbps(generation)
                ring_min = 0.0
            pod = self._workload_pod(
                name,
                checks="",
                tpu_request=_allocatable_cards(member),
                owner=owner,
                min_gbps=min_gbps,
                ring_min_gbps=ring_min,
            )
            pod["metadata"]["labels"]["tpu.google.com/slice-group"] = svc
            pod["metadata"]["labels"][EPOCH_LABEL] = epoch
            spec = pod["spec"]
            spec["nodeName"] = node
            # the pod's DNS record under the headless Service
            spec["hostname"] = name
            spec["subdomain"] = svc
            container = spec["containers"][0]
            container["command"] = list(DISTRIBUTED_COMMAND)
            container["env"] += [
                {"name": "COORDINATOR_ADDRESS", "value": coordinator},
                {"name": "NUM_PROCESSES", "value": str(len(members))},
                {"name": "PROCESS_ID", "value": str(wid)},
            ]
            if not gate_slice:
                # cross-slice figures in their own drop-box scope, never
                # over the slice's
                container["env"].append({"name": "RESULTS_SCOPE", "value": "multislice"})
            try:
                await client.create(pod)
            except ApiError as e:
                # another worker converged this name at once, or the old pod
                # is still terminating; the next poll's epoch check decides
                if not e.already_exists:
                    raise

    async def _cleanup_group_workloads(
        self,
        key: str,
        members: list[dict],
        svc: str,
        epoch: str,
        ids: dict[str, int],
        base: str = "tpu-jax-validation",
    ) -> None:
        """Once every member pod of this epoch has Succeeded, record the
        epoch on the Service, then delete the pods.  Bounded and best-effort;
        the pods go only after the tombstone landed, so a crash in between
        costs one re-proof, never a false pass."""
        from tpu_operator_torch.k8s import nodeinfo

        client = self.client()
        names = [self._group_pod_name(key, ids[nodeinfo.node_name(m)], base) for m in members]
        for _ in range(min(60, self.config.workload_retries)):
            done = 0
            for name in names:
                try:
                    pod = await client.get("", "Pod", name, self.config.namespace)
                except ApiError as e:
                    if not e.not_found:
                        raise
                    # already gone: absence must not hold back the tombstone
                    # the remaining Succeeded pods have earned
                    done += 1
                    continue
                if (((pod.get("metadata") or {}).get("labels") or {}).get(EPOCH_LABEL) == epoch
                        and (pod.get("status") or {}).get("phase") == "Succeeded"):
                    done += 1
            if done == len(names):
                break
            await asyncio.sleep(self.config.sleep_interval)
        else:
            log.info(
                "slice %s: not all validation pods finished; leaving them in place", key,
            )
            return
        await client.patch(
            "", "Service", svc,
            {"metadata": {"annotations": {VALIDATED_EPOCH_ANNOTATION: epoch}}},
            self.config.namespace,
        )
        for name in names:
            await client.delete("", "Pod", name, self.config.namespace)

    async def validate_vfio(self) -> None:
        devices = hw.vfio_device_paths()
        if not devices:
            raise ValidationError("no /dev/vfio group devices bound")
        status.write_ready("vfio-pci", {"devices": devices})

    # ------------------------------------------------------------------
    async def _node_chip_count(self) -> int:
        return _allocatable_cards(await self.client().get("", "Node", self.config.node_name))

    async def _owner_daemonset(self) -> Optional[dict]:
        try:
            return await self.client().get(
                "apps", "DaemonSet", "tpu-operator-validator", self.config.namespace
            )
        except ApiError:
            return None

    def _workload_pod(
        self,
        name: str,
        checks: str,
        tpu_request: int,
        owner: Optional[dict],
        min_gbps: float = 0.0,
        ring_min_gbps: float = 0.0,
        results_scope: str = "",
        budget_seconds: float = 0.0,
        cache_key_env: Optional[dict] = None,
    ) -> dict:
        """The workload pod: pinned to the node, ``tpu_request`` cards of
        ``nvidia.com/gpu``, owner reference and tolerations copied from the
        validator DaemonSet.  ``min_gbps`` arms the allreduce gate and
        ``ring_min_gbps`` the per-link ring gate (0 keeps them report-only);
        ``results_scope`` namespaces the drop-box.  The pod runs on the card:
        its env carries no ``TORCH_DEVICE``."""
        image = self.config.workload_image or "ghcr.io/tpu-operator/tpu-validator:latest"
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": self.config.namespace,
                "labels": {"app": name},
            },
            "spec": {
                "nodeName": self.config.node_name,
                "restartPolicy": "Never",
                "containers": [
                    {
                        "name": "workload",
                        "image": image,
                        "command": list(WORKLOAD_COMMAND),
                        "env": [
                            {"name": "WORKLOAD_CHECKS", "value": checks},
                            {"name": "ALLREDUCE_MIN_GBPS", "value": str(min_gbps)},
                            {"name": "RING_MIN_GBPS", "value": str(ring_min_gbps)},
                            # device-count truth: the pod requested this many
                            # cards; CUDA inside it must see exactly that many
                            {"name": "EXPECTED_DEVICES", "value": str(tpu_request)},
                            {"name": "TPU_COMPILE_CACHE", "value": consts.COMPILE_CACHE_DIR},
                            # the kernel-library store: a joining node fetches
                            # the libraries instead of building them
                            {
                                "name": "TPU_COMPILE_CACHE_ARTIFACTS",
                                "value": consts.COMPILE_CACHE_DIR + "/artifacts",
                            },
                            # the fleet cache URL and the cache-key fields:
                            # an explicit env wins, else spawn_workload's
                            # values from the node and this runtime
                            *(
                                [{"name": env_name, "value": value}
                                 for env_name in ("TPU_FLEET_CACHE_URL",
                                                  "TPU_CACHE_GENERATION",
                                                  "TPU_CACHE_TOPOLOGY",
                                                  "TPU_LIBTPU_VERSION")
                                 for value in (
                                     os.environ.get(env_name)
                                     or (cache_key_env or {}).get(env_name, ""),
                                 )
                                 if value]
                            ),
                            *(
                                [{"name": "RESULTS_SCOPE", "value": results_scope}]
                                if results_scope
                                else []
                            ),
                            # live telemetry through the node's metrics agent
                            *(
                                [{
                                    "name": "TPU_METRICS_PUSH_URL",
                                    "value": os.environ["TPU_METRICS_PUSH_URL"],
                                }]
                                if os.environ.get("TPU_METRICS_PUSH_URL")
                                else []
                            ),
                            # the pod continues the validator's active span,
                            # else relays the DaemonSet's rollout context
                            *(
                                [{
                                    "name": trace.TRACEPARENT_ENV,
                                    "value": (
                                        trace.current_traceparent()
                                        or os.environ[trace.TRACEPARENT_ENV]
                                    ),
                                }]
                                if trace.current_traceparent()
                                or os.environ.get(trace.TRACEPARENT_ENV)
                                else []
                            ),
                            # the probe pod stops starting checks past this
                            *(
                                [{
                                    "name": "WORKLOAD_BUDGET_S",
                                    "value": str(budget_seconds),
                                }]
                                if budget_seconds
                                else []
                            ),
                        ],
                        "resources": {
                            "limits": {consts.GPU_RESOURCE: str(tpu_request)},
                            "requests": {consts.GPU_RESOURCE: str(tpu_request)},
                        },
                        "volumeMounts": [
                            # exactly two narrow mounts: the cache and the
                            # drop-box — never the ready markers a
                            # misbehaving workload could forge
                            {
                                "name": "compile-cache",
                                "mountPath": consts.COMPILE_CACHE_DIR,
                            },
                            {
                                "name": "workload-results",
                                "mountPath": consts.WORKLOAD_RESULTS_DIR,
                            },
                        ],
                    }
                ],
                "volumes": [
                    {
                        "name": "compile-cache",
                        "hostPath": {
                            "path": consts.COMPILE_CACHE_DIR,
                            "type": "DirectoryOrCreate",
                        },
                    },
                    {
                        "name": "workload-results",
                        "hostPath": {
                            "path": consts.WORKLOAD_RESULTS_DIR,
                            "type": "DirectoryOrCreate",
                        },
                    },
                ],
            },
        }
        if owner is not None:
            from tpu_operator_torch.k8s.client import set_owner_reference

            set_owner_reference(pod, owner)
            tolerations = (((owner.get("spec") or {}).get("template") or {}).get("spec")
                           or {}).get("tolerations")
            if tolerations:
                pod["spec"]["tolerations"] = copy.deepcopy(tolerations)
        return pod

    async def _cache_key_env(self) -> dict:
        """The warm pool's cache-key fields for the workload pod: the card
        from the node's product label and its topology label, and the CUDA
        version the pod's own key carries (``compile_cache.
        current_versions``, under the reference's ``TPU_LIBTPU_VERSION``).
        Best-effort: a node that cannot be read leaves its fields empty."""
        from tpu_operator_torch.workloads import compile_cache

        env = {"TPU_LIBTPU_VERSION": compile_cache.current_versions()[1]}
        if self.config.node_name:
            try:
                node = await self.client().get("", "Node", self.config.node_name)
            except ApiError:
                return env
            labels = (node.get("metadata") or {}).get("labels") or {}
            env["TPU_CACHE_GENERATION"] = labels.get(consts.GPU_PRODUCT_LABEL, "")
            env["TPU_CACHE_TOPOLOGY"] = labels.get(consts.GKE_TPU_TOPOLOGY_LABEL, "")
        return env

    async def spawn_workload(
        self,
        name: str,
        checks: str,
        tpu_request: int,
        min_gbps: float = 0.0,
        ring_min_gbps: float = 0.0,
        results_scope: str = "",
        budget_seconds: float = 0.0,
    ) -> None:
        client = self.client()
        owner = await self._owner_daemonset()
        pod = self._workload_pod(
            name, checks, tpu_request, owner, min_gbps=min_gbps,
            ring_min_gbps=ring_min_gbps, results_scope=results_scope,
            budget_seconds=budget_seconds, cache_key_env=await self._cache_key_env(),
        )
        await client.delete("", "Pod", name, self.config.namespace)
        await client.create(pod)
        phase = None
        for _ in range(self.config.workload_retries):
            live = await client.get("", "Pod", name, self.config.namespace)
            phase = (live.get("status") or {}).get("phase")
            if phase == "Succeeded":
                return
            if phase == "Failed":
                raise ValidationError(f"workload pod {name} failed")
            await asyncio.sleep(self.config.sleep_interval)
        raise ValidationError(f"workload pod {name} did not complete (phase={phase})")
