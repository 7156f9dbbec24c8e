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

A member of a multi-host slice is refused: its validation is one program
across every host of the slice, which the port does not run yet.
"""

from __future__ import annotations

import asyncio
import calendar
import copy
import functools
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

# Fractions of the card's data-sheet NVLink figures the gates require
# (``k8s/nodeinfo.py`` derives the ceilings): the reference's values.
ALLREDUCE_GATE_FRACTION = 0.25
RING_GATE_FRACTION = 0.25
# of the host's NIC line rate, for traffic between hosts
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


def _multislice_min_gbps(generation: str = "") -> float:
    """The floor for an allreduce between hosts, from the catalogue's host
    NIC rate (unknown generations keep it report-only; MULTISLICE_MIN_GBPS
    overrides either way)."""
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

    async def _refuse_slice_member(self) -> None:
        """Raise on a member of a multi-host slice (a node whose slice spans
        several hosts): its gate is one program across every host, and a
        node-local gate in its place would prove the wrong thing."""
        if not self.config.node_name:
            return
        from tpu_operator_torch.k8s import nodeinfo

        node = await self.client().get("", "Node", self.config.node_name)
        key = nodeinfo.slice_group_key(node)
        if key:
            raise ValidationError(
                f"node {self.config.node_name} is a member of the multi-host slice {key}: "
                "multi-host slice validation is not ported yet"
            )

    async def validate_jax(self) -> None:
        """The readiness gate over every local card: vector-add, allreduce
        and, on several cards, the sharded burn-in."""
        await self.wait_ready("plugin", retries=self.config.resource_retries)
        # fresh flight record for this round: recorders append, so the one
        # per-node coordinator clears stale samples before any writer starts
        status.clear_flight_record()
        if self.config.with_workload:
            await self._refuse_slice_member()
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

            await self._refuse_slice_member()
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

    async def validate_vfio(self) -> None:
        devices = hw.vfio_device_paths()
        if not devices:
            raise ValidationError("no /dev/vfio group devices bound")
        status.write_ready("vfio-pci", {"devices": devices})

    # ------------------------------------------------------------------
    async def _node_chip_count(self) -> int:
        node = await self.client().get("", "Node", self.config.node_name)
        alloc = (node.get("status") or {}).get("allocatable") or {}
        try:
            return max(1, int(alloc.get(consts.GPU_RESOURCE, "1")))
        except ValueError:
            return 1

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
