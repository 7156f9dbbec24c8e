"""The metrics agent on an NVIDIA node: port of
``tpu_operator/agents/metrics_agent.py`` (the DCGM hostengine analogue), a
standalone sampler on a hostPort that the exporter scrapes, so several
consumers share one sampler.

The reference scrapes libtpu's per-chip runtime endpoints (ports 8431+i);
here the card counters come from NVML (``tpu_operator_torch/nvml.py``),
one series per card NVML lists, under the reference's counter names:

- ``tpu_duty_cycle_percent``: NVML's GPU utilization, the share of the last
  sample period (up to a second by product) in which a kernel ran;
- ``tpu_hbm_memory_total_bytes``, ``tpu_hbm_memory_usage_bytes``: NVML's
  memory info (the CUDA contexts and the caching allocators' reserves count
  as used: compare differences, not absolute values);
- ``tpu_ici_transmitted_bytes_total``, ``tpu_ici_received_bytes_total``:
  the NVLink data counters summed over the links;
- ``tpu_tensorcore_utilization_percent``: NVML has no tensor-core activity
  counter, so it keeps the reference's zero fill for an absent counter;
- ``tpu_chip_scrape_errors_total``: failed NVML queries of the card, as the
  reference counts unreachable endpoints.  A counter the card does not
  support is zero-filled, not an error.

Workload telemetry pushed to ``/push`` (the flight recorder's sink), the
fleet forward hop (``TPU_FLEET_PUSH_URL``) and the compile-cache relay are
the reference's, copied.  Serves JSON at /counters and Prometheus text at
/metrics.  ``aiohttp`` is imported only by the HTTP paths (``serve``, the
forward hop, ``main``): the collectors run without it.

    AGENT_PORT=5555 python -m tpu_operator_torch.agents.metrics_agent
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Optional

from tpu_operator_torch import consts, nvml
from tpu_operator_torch.agents import base
from tpu_operator_torch.obs.profile import MAX_STEPS_PER_PUSH, clean_steps
from tpu_operator_torch.obs.trace import TraceContext

log = logging.getLogger("tpu_operator_torch.metrics_agent")

# join→validated critical-path phases, in pipeline order: the only phase
# names the forward hop passes on (the operator's fleet ingest accepts no
# others)
JOIN_PHASES = (
    "runtime-ready",
    "validator-scheduled",
    "plugin-advertised",
    "compile",
    "collective",
)

# fleet forward hop: at most one POST to the operator per this many
# seconds; windows merge while throttled (the flight recorder's own push
# discipline, one level up)
FLEET_FORWARD_INTERVAL = 1.0

# canonical counter names (tpu_ prefix mirrors DCGM_FI_* naming discipline)
COUNTERS = (
    "tpu_duty_cycle_percent",
    "tpu_tensorcore_utilization_percent",
    "tpu_hbm_memory_total_bytes",
    "tpu_hbm_memory_usage_bytes",
    "tpu_ici_transmitted_bytes_total",
    "tpu_ici_received_bytes_total",
    # agent-synthesized (never scraped): cumulative failed scrapes of the
    # chip's runtime metrics endpoint — the node-local health signal the
    # node-status-exporter turns into a tpu-health verdict
    "tpu_chip_scrape_errors_total",
)

# workload telemetry counters accepted on /push (fed by obs.flight
# recorders inside validation/bench workloads); exported with
# source="workload" + workload labels next to the per-chip series
WORKLOAD_COUNTERS = (
    "tpu_workload_step_duration_seconds",
    "tpu_workload_compile_seconds",
    "tpu_workload_achieved_gbps",
    "tpu_workload_achieved_tflops",
    "tpu_workload_mfu",
    "tpu_workload_tokens_per_sec",
    "tpu_workload_overhead_dominated",
    "tpu_workload_steps_total",
    # compile-artifact cache counters (workloads/compile_cache.py): pushed
    # by validation workloads so the fleet plane sees hit/miss/bytes per
    # node — the evidence behind the warm-pool join gate
    "tpu_workload_compile_cache_hits_total",
    "tpu_workload_compile_cache_misses_total",
    "tpu_workload_compile_cache_bytes_total",
    # sustained-serving counters (workloads/serving.py): the continuous-
    # batching replica's rolling telemetry, pushed per engine step.  The
    # label vocabulary stays BOUNDED by construction: the only label is
    # the workload name (the replica's TPU_SERVE_NAME); request ids live
    # in flight samples only and must never become label values — the
    # PushStore/FleetForwarder cardinality caps depend on it.
    "tpu_workload_serving_tokens_per_sec",
    "tpu_workload_serving_ttft_p99_seconds",
    "tpu_workload_serving_tpot_p99_seconds",
    "tpu_workload_serving_queue_depth",
    "tpu_workload_serving_batch_size",
    "tpu_workload_serving_kv_blocks_free",
    "tpu_workload_serving_requests_completed_total",
    "tpu_workload_serving_requests_rejected_total",
    "tpu_workload_serving_decoded_tokens_total",
    # chip-time accounting evidence (workloads/checkpoint.py training
    # loop + restore path): cumulative useful/wasted busy seconds and the
    # stamp-derived replay/loss deltas the operator-side ledger
    # (obs/accounting.py) carves chip-time with
    "tpu_workload_checkpoint_seconds",
    "tpu_workload_restore_seconds",
    "tpu_workload_useful_seconds_total",
    "tpu_workload_wasted_seconds_total",
    "tpu_workload_replayed_steps_total",
    "tpu_workload_lost_steps_total",
)

# HELP text per counter: the exposition format wants a # HELP line per
# family, and operators reading a raw scrape deserve better than a name
COUNTER_HELP = {
    "tpu_duty_cycle_percent": "Percent of the last sample period in which a kernel ran on the card (NVML GPU utilization)",
    "tpu_tensorcore_utilization_percent": "Tensor-core utilization percent (no NVML source: always 0)",
    "tpu_hbm_memory_total_bytes": "Total device memory in bytes",
    "tpu_hbm_memory_usage_bytes": "Device memory bytes in use, CUDA contexts and allocator reserves included",
    "tpu_ici_transmitted_bytes_total": "NVLink data bytes transmitted, summed over the links",
    "tpu_ici_received_bytes_total": "NVLink data bytes received, summed over the links",
    "tpu_chip_scrape_errors_total": "Failed NVML queries of the card since agent start",
    "tpu_workload_step_duration_seconds": "Last workload step wall time in seconds",
    "tpu_workload_compile_seconds": "Workload compile (warmup) wall time in seconds",
    "tpu_workload_achieved_gbps": "Workload-achieved bandwidth in GB/s",
    "tpu_workload_achieved_tflops": "Workload-achieved compute in TFLOP/s",
    "tpu_workload_mfu": "Workload model-flops utilization (0-1)",
    "tpu_workload_tokens_per_sec": "Workload training/serving throughput in tokens/s",
    "tpu_workload_overhead_dominated": "1 when the workload measurement was overhead-dominated",
    "tpu_workload_steps_total": "Workload telemetry samples recorded",
    "tpu_workload_compile_cache_hits_total": "Compile-artifact cache hits (executables loaded from disk instead of compiled)",
    "tpu_workload_compile_cache_misses_total": "Compile-artifact cache misses (programs that paid the XLA compiler)",
    "tpu_workload_compile_cache_bytes_total": "Bytes read+written through the node's compile-artifact store",
    "tpu_workload_serving_tokens_per_sec": "Serving replica rolling decode throughput in tokens/s",
    "tpu_workload_serving_ttft_p99_seconds": "Serving replica rolling p99 time-to-first-token",
    "tpu_workload_serving_tpot_p99_seconds": "Serving replica rolling p99 time-per-output-token",
    "tpu_workload_serving_queue_depth": "Requests queued behind the serving replica's admission control",
    "tpu_workload_serving_batch_size": "Requests in the serving replica's running decode batch",
    "tpu_workload_serving_kv_blocks_free": "Free KV-cache blocks in the serving replica's paged pool",
    "tpu_workload_serving_requests_completed_total": "Requests the serving replica completed since start",
    "tpu_workload_serving_requests_rejected_total": "Requests rejected by serving admission (oversize for the configured context)",
    "tpu_workload_serving_decoded_tokens_total": "Decode tokens the serving replica produced since start (chip-time busy_useful evidence)",
    "tpu_workload_checkpoint_seconds": "Last checkpoint save wall time in seconds",
    "tpu_workload_restore_seconds": "Last checkpoint restore wall time in seconds",
    "tpu_workload_useful_seconds_total": "Cumulative busy seconds spent on first-time training steps (chip-time busy_useful evidence)",
    "tpu_workload_wasted_seconds_total": "Cumulative busy seconds spent on replayed steps plus checkpoint/restore overhead (chip-time busy_wasted evidence)",
    "tpu_workload_replayed_steps_total": "Steps recomputed at-or-below the pre-restart HIGHWATER stamp",
    "tpu_workload_lost_steps_total": "Stamp-derived steps lost at restore (HIGHWATER minus restored snapshot step)",
}


# NVML's sample keys (nvml.sample) → counter names
_SOURCES = {
    "gpu_utilization_percent": "tpu_duty_cycle_percent",
    "memory_total_bytes": "tpu_hbm_memory_total_bytes",
    "memory_used_bytes": "tpu_hbm_memory_usage_bytes",
    "nvlink_tx_bytes": "tpu_ici_transmitted_bytes_total",
    "nvlink_rx_bytes": "tpu_ici_received_bytes_total",
}


class FleetForwarder:
    """The agent's hop onto the operator's fleet telemetry plane.

    When ``TPU_FLEET_PUSH_URL`` is set (the DS template points it at the
    operator metrics Service), every accepted workload push is merged into
    a pending window and forwarded — with the node name and the cumulative
    chip scrape-error total — to the operator's ``POST /push`` ingest
    route, throttled to one POST per ``interval`` with exponential backoff
    on failure.  Event-driven only: a quiet node forwards nothing, so the
    hop adds zero steady-state traffic."""

    def __init__(
        self,
        url: str,
        node_name: str = "",
        scrape_errors: Optional[dict] = None,
        interval: float = FLEET_FORWARD_INTERVAL,
    ):
        self.url = url
        self.node_name = node_name
        self.scrape_errors = scrape_errors if scrape_errors is not None else {}
        self.interval = interval
        self.forwarded = 0
        self.failures = 0
        self._pending: dict[str, dict] = {}
        # join-phase segments awaiting forward ({phase: seconds}, merged
        # like counters) and the newest propagated trace id of the window.
        # The agent's own TPU_TRACEPARENT (DS-injected rollout context) is
        # the stamp of last resort: a push without one still joins the
        # rollout trace, just not a workload-specific span.
        self._pending_join: dict[str, float] = {}
        env_ctx = TraceContext.from_env()
        self._env_trace_id = env_ctx.trace_id if env_ctx is not None else ""
        self._pending_trace = ""
        self._task: Optional[asyncio.Task] = None

    def queue(
        self,
        workloads: dict,
        trace_id: str = "",
        join_phases: Optional[dict] = None,
    ) -> None:
        """Merge a push window for forwarding.  The SAME validation and
        cardinality discipline as PushStore applies — only catalogue
        counters and catalogue join phases, distinct workload names capped
        — or the unauthenticated hostPort could grow the pending map and
        the operator's fleet series without bound through the hop while
        the agent's own surface stays clean."""
        if not self.url:
            return
        for check, entry in workloads.items():
            if not isinstance(entry, dict):
                continue
            counters = {
                k: float(v)
                for k, v in ((entry or {}).get("counters") or {}).items()
                if k in WORKLOAD_COUNTERS and isinstance(v, (int, float))
            }
            # step-profile windows ride the same hop with the same
            # discipline: validated shape, bounded phase vocabulary,
            # per-check window cap (obs/profile.clean_steps is the shared
            # gate the fleet ingest applies again)
            steps = clean_steps(entry.get("steps"))
            if not counters and not steps:
                continue
            name = str(check)
            if (
                name not in self._pending
                and len(self._pending) >= PushStore.MAX_WORKLOADS
            ):
                continue
            live = self._pending.setdefault(name, {"counters": {}})
            live["counters"].update(counters)
            if steps:
                queue = live.setdefault("steps", [])
                seen = {s["step_seq"] for s in queue}
                queue.extend(s for s in steps if s["step_seq"] not in seen)
                del queue[:-MAX_STEPS_PER_PUSH]
        for phase, seconds in (join_phases or {}).items():
            if phase in JOIN_PHASES and isinstance(seconds, (int, float)):
                self._pending_join[phase] = float(seconds)
        if trace_id and isinstance(trace_id, str) and len(trace_id) <= 32:
            self._pending_trace = trace_id
        if (self._pending or self._pending_join) and (
            self._task is None or self._task.done()
        ):
            self._task = asyncio.create_task(self._drain())
            self._task.add_done_callback(self._drain_finished)

    @staticmethod
    def _drain_finished(task: asyncio.Task) -> None:
        """The drain loop handles transport errors itself; anything else
        escaping it must not vanish with the task reference (an unretained
        task swallows its exception on GC)."""
        if not task.cancelled() and task.exception() is not None:
            log.warning("fleet forward drain crashed: %r", task.exception())

    async def _drain(self) -> None:
        import aiohttp

        backoff = 0
        # one session for the drain's lifetime: keep-alive to the operator
        # Service instead of a fresh connector + DNS lookup per POST —
        # at fleet scale that is one connection per node, not one per push
        async with aiohttp.ClientSession() as session:
            while self._pending or self._pending_join:
                window, self._pending = self._pending, {}
                join_window, self._pending_join = self._pending_join, {}
                trace_id = self._pending_trace or self._env_trace_id
                self._pending_trace = ""
                body = {
                    "node": self.node_name,
                    "workloads": window,
                    "chips": {
                        "scrape_errors_total": float(
                            sum(self.scrape_errors.values())
                        ),
                    },
                }
                if join_window:
                    body["join_phases"] = join_window
                if trace_id:
                    body["trace_id"] = trace_id
                try:
                    async with session.post(
                        self.url, json=body,
                        timeout=aiohttp.ClientTimeout(total=2),
                    ) as resp:
                        ok = resp.status < 400
                except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                    ok = False
                if ok:
                    self.forwarded += 1
                    backoff = 0
                else:
                    self.failures += 1
                    backoff = min(5, backoff + 1)
                    # merge the failed window back; counters recorded since win
                    for check, entry in window.items():
                        live = self._pending.setdefault(check, {"counters": {}})
                        live["counters"] = {**entry["counters"], **live["counters"]}
                        steps = entry.get("steps")
                        if steps:
                            queue = live.setdefault("steps", [])
                            seen = {s["step_seq"] for s in queue}
                            queue[:0] = [
                                s for s in steps if s["step_seq"] not in seen
                            ]
                            queue.sort(key=lambda s: s["step_seq"])
                            del queue[:-MAX_STEPS_PER_PUSH]
                    self._pending_join = {**join_window, **self._pending_join}
                    if trace_id and not self._pending_trace:
                        self._pending_trace = trace_id
                await asyncio.sleep(self.interval * (2**backoff if backoff else 1))


class PushStore:
    """Live workload counters pushed by obs.flight recorders.

    Entries expire after ``ttl`` seconds: a workload that stopped pushing
    (finished, crashed) must drop off /metrics instead of freezing its last
    figures there forever.  Unknown counter names are rejected — the
    exported surface is the WORKLOAD_COUNTERS catalogue, which the docs
    drift-check (hack/check_counter_docs.py) pins.  Distinct workload
    names are capped (``max_workloads``): the port is an unauthenticated
    hostPort, and workload label values arrive from the network — without
    a cap a chatty or hostile client could grow agent memory and
    Prometheus series cardinality without bound."""

    MAX_WORKLOADS = 64

    def __init__(self, ttl: float = 300.0, max_workloads: int = MAX_WORKLOADS):
        self.ttl = ttl
        self.max_workloads = max_workloads
        self._entries: dict[str, dict] = {}  # workload -> {ts, counters}

    def push(self, workloads: dict) -> int:
        accepted = 0
        now = time.time()
        for workload, entry in workloads.items():
            if not isinstance(entry, dict):
                continue
            counters = {
                k: float(v)
                for k, v in (entry.get("counters") or {}).items()
                if k in WORKLOAD_COUNTERS and isinstance(v, (int, float))
            }
            # step-profile windows pass through the store too (bounded,
            # shape-validated): a step-only push must still count as
            # accepted or the fleet forward hop behind it never fires
            steps = clean_steps(entry.get("steps"))
            if not counters and not steps:
                continue
            name = str(workload)
            if name not in self._entries and len(self._entries) >= self.max_workloads:
                # prune expired entries first; past the cap, new names are
                # dropped rather than growing the series set unboundedly
                self.snapshot()
                if len(self._entries) >= self.max_workloads:
                    continue
            # MERGE over the live entry: push windows carry only what
            # changed since the last POST (the recorder drains pending),
            # so a counter recorded once — compile_s — must survive later
            # windows, not vanish mid-run before the TTL says so
            live = self._entries.setdefault(name, {"ts": now, "counters": {}})
            live["ts"] = now
            live["counters"].update(counters)
            if steps:
                window = live.setdefault("steps", [])
                seen = {s["step_seq"] for s in window}
                window.extend(s for s in steps if s["step_seq"] not in seen)
                del window[:-MAX_STEPS_PER_PUSH]
            accepted += 1
        return accepted

    def snapshot(self) -> dict[str, dict]:
        now = time.time()
        self._entries = {
            w: e for w, e in self._entries.items() if now - e["ts"] <= self.ttl
        }
        return {w: dict(e["counters"]) for w, e in self._entries.items()}


def card_counters(scrape_errors: Optional[dict] = None) -> dict:
    """Per-card counter map {NVML index: {counter: value}} from one NVML
    query per card.  ``scrape_errors`` (card → cumulative failures, owned
    by the caller so it persists across collections) feeds the
    ``tpu_chip_scrape_errors_total`` counter: a card NVML cannot query must
    be VISIBLE as a health signal, not zero-filled into the shape of an
    idle card.  Raises :class:`nvml.NvmlError` when NVML itself is
    missing."""
    scrape_errors = scrape_errors if scrape_errors is not None else {}
    per_chip: dict[int, dict] = {}
    for card in nvml.inventory().cards:
        try:
            sample = nvml.sample(card)
        except nvml.NvmlError as e:
            log.warning("card %d (%s): %s", card.index, card.uuid, e)
            sample = {}
            scrape_errors[card.index] = scrape_errors.get(card.index, 0) + 1
        per_chip[card.index] = {
            counter: sample[key] for key, counter in _SOURCES.items() if key in sample
        }
    # a card with failures stays in the snapshot, its counter monotonic
    for chip in scrape_errors:
        per_chip.setdefault(chip, {})
    # shape-stable zero fill
    for chip, counters in per_chip.items():
        for counter in COUNTERS:
            counters.setdefault(counter, 0.0)
        counters["tpu_chip_scrape_errors_total"] = float(scrape_errors.get(chip, 0))
    return per_chip


async def collect(
    push_store: Optional[PushStore] = None,
    scrape_errors: Optional[dict] = None,
) -> dict:
    """The agent's snapshot: ``{"ts", "chips": card_counters(...)}`` plus
    the pushed workload counters.  NVML's calls block, so they run off the
    event loop."""
    per_chip = await asyncio.to_thread(card_counters, scrape_errors)
    snapshot = {"ts": time.time(), "chips": per_chip}
    if push_store is not None:
        snapshot["workloads"] = push_store.snapshot()
    return snapshot


async def read_bytes_capped(request, limit: int):
    """Size-guarded raw body read for the unauthenticated POST routes.
    Returns ``(body, None)`` or ``(None, error_response)``: 413 past the cap
    (declared Content-Length or actual bytes)."""
    from aiohttp import web

    if request.content_length is not None and request.content_length > limit:
        return None, web.json_response(
            {"error": f"payload exceeds {limit} bytes"}, status=413
        )
    # read() must LOOP: StreamReader.read(n) returns whatever is buffered
    # once any bytes arrive, and a body spanning several TCP segments would
    # otherwise be truncated
    chunks: list[bytes] = []
    remaining = limit + 1
    while remaining > 0:
        chunk = await request.content.read(remaining)
        if not chunk:
            break
        chunks.append(chunk)
        remaining -= len(chunk)
    body = b"".join(chunks)
    if len(body) > limit:
        return None, web.json_response(
            {"error": f"payload exceeds {limit} bytes"}, status=413
        )
    return body, None


async def read_json_capped(request, limit: int = consts.PUSH_MAX_BYTES):
    """Size-guarded JSON body read (:func:`read_bytes_capped` + parse);
    400 on bad JSON."""
    from aiohttp import web

    body, error = await read_bytes_capped(request, limit)
    if error is not None:
        return None, error
    try:
        return json.loads(body), None
    except (UnicodeDecodeError, ValueError):
        return None, web.json_response({"error": "invalid JSON"}, status=400)


def _escape_label(value) -> str:
    """Prometheus exposition label escaping: backslash, quote, newline —
    a node name with '"' or '\\' must not corrupt the exposition."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def to_prometheus(
    snapshot: dict,
    extra_labels: Optional[dict] = None,
    allow: Optional[set] = None,
) -> str:
    """Prometheus text for a counter snapshot; shared with the exporter
    (extra node labels + counter allowlist).  Chip counters render per
    chip; pushed workload counters render per workload with a
    ``source="workload"`` label.  Every family gets # HELP and # TYPE."""
    prefix = "".join(
        f'{k}="{_escape_label(v)}",' for k, v in (extra_labels or {}).items()
    )
    lines = []

    def _family(counter: str) -> None:
        kind = "counter" if counter.endswith("_total") else "gauge"
        lines.append(f"# HELP {counter} {COUNTER_HELP.get(counter, counter)}")
        lines.append(f"# TYPE {counter} {kind}")

    for counter in COUNTERS:
        if allow is not None and counter not in allow:
            continue
        _family(counter)
        for chip, values in sorted(snapshot.get("chips", {}).items()):
            lines.append(
                f'{counter}{{{prefix}chip="{_escape_label(chip)}"}}'
                f" {values.get(counter, 0.0)}"
            )
    workloads = snapshot.get("workloads") or {}
    for counter in WORKLOAD_COUNTERS:
        if allow is not None and counter not in allow:
            continue
        rows = [
            (workload, counters[counter])
            for workload, counters in sorted(workloads.items())
            if counter in counters
        ]
        if not rows:
            continue
        _family(counter)
        for workload, value in rows:
            lines.append(
                f'{counter}{{{prefix}source="workload",'
                f'workload="{_escape_label(workload)}"}} {value}'
            )
    return "\n".join(lines) + "\n"


async def serve(
    port: int,
    stop: asyncio.Event,
    cache_ttl: float = 1.0,
    push_ttl: float = 300.0,
) -> None:
    import aiohttp
    from aiohttp import web

    # shared-sampler contract: concurrent scrapers within the TTL reuse one
    # collection instead of re-hitting every per-chip runtime endpoint
    cache: dict = {"snapshot": {"ts": 0.0, "chips": {}}}
    push_store = PushStore(ttl=push_ttl)
    scrape_errors: dict[int, int] = {}  # chip → cumulative failed scrapes
    fleet_url = os.environ.get(consts.FLEET_PUSH_ENV, "")
    forwarder = (
        FleetForwarder(
            fleet_url,
            node_name=os.environ.get("NODE_NAME", ""),
            scrape_errors=scrape_errors,
        )
        if fleet_url
        else None
    )
    # the TTL check+collect must be atomic: without the lock, N scrapers
    # arriving inside one TTL window each saw a stale ts and each ran a
    # full collect() pass, defeating the shared-sampler contract
    refresh_lock = asyncio.Lock()

    async def refresh() -> dict:
        async with refresh_lock:
            if time.time() - cache["snapshot"]["ts"] >= cache_ttl:
                cache["snapshot"] = await collect(push_store, scrape_errors)
            else:
                # pushed counters are point-in-time already; serve the
                # freshest even from a cached chip snapshot
                cache["snapshot"]["workloads"] = push_store.snapshot()
        return cache["snapshot"]

    async def counters_handler(request: web.Request) -> web.Response:
        return web.json_response(await refresh())

    async def metrics_handler(request: web.Request) -> web.Response:
        return web.Response(text=to_prometheus(await refresh()), content_type="text/plain")

    async def push_handler(request: web.Request) -> web.Response:
        # size-capped read (413 past PUSH_MAX_BYTES): the hostPort is
        # unauthenticated and an unbounded body is an allocation amplifier
        body, error = await read_json_capped(request)
        if error is not None:
            return error
        if not isinstance(body, dict):
            return web.json_response({"error": "body must be an object"}, status=400)
        workloads = body.get("workloads")
        join_phases = body.get("join_phases")
        if not isinstance(workloads, dict) and not isinstance(join_phases, dict):
            return web.json_response(
                {"error": "missing workloads map"}, status=400
            )
        accepted = push_store.push(workloads) if isinstance(workloads, dict) else 0
        if forwarder is not None and (
            accepted or isinstance(join_phases, dict)
        ):
            # fleet hop: accepted windows — and the validator's join-phase
            # report with its propagated trace id — ride on to the
            # operator's ingest
            forwarder.queue(
                workloads if isinstance(workloads, dict) else {},
                trace_id=body.get("trace_id") or "",
                join_phases=join_phases if isinstance(join_phases, dict) else None,
            )
        return web.json_response({"accepted": accepted})

    # compile-artifact cache relay (workloads/compile_cache.py): workload
    # pods on this node reach the operator's /compile-cache/* surface
    # through the agent hop, same as their /push telemetry rides the
    # FleetForwarder.  The relay enforces the cache's own discipline at
    # this hop too — artifact names must be content digests, kind
    # fingerprints must look like fingerprints, and POST bodies are capped
    # — so a hostile client cannot launder garbage through the node port.
    from tpu_operator_torch.workloads import compile_cache as cc

    cache_base = os.environ.get(cc.FLEET_CACHE_URL_ENV, "") or (
        fleet_url.rsplit("/push", 1)[0] if fleet_url.endswith("/push") else ""
    )

    async def cc_relay(request: web.Request) -> web.Response:
        if not cache_base:
            return web.json_response(
                {"error": "no fleet cache configured"}, status=404
            )
        tail = request.match_info.get("tail", "")
        if request.method == "GET" and tail == "index":
            kind = request.rel_url.query.get("kind", "")
            if not cc.valid_artifact_name(kind):
                return web.json_response({"error": "bad kind"}, status=400)
            url = f"{cache_base}/compile-cache/index?kind={kind}"
            body = None
        elif request.method == "GET" and tail.startswith("artifact/"):
            name = tail[len("artifact/"):]
            if not cc.valid_artifact_name(name):
                return web.json_response({"error": "bad artifact name"}, status=400)
            url = f"{cache_base}/compile-cache/artifact/{name}"
            body = None
        elif request.method == "POST" and tail == "artifact":
            # capped looping read (shared helper): a multi-megabyte
            # envelope spans many TCP segments and a single read would
            # truncate every large artifact at the hop
            body, error = await read_bytes_capped(request, cc.ARTIFACT_MAX_BYTES)
            if error is not None:
                return error
            url = f"{cache_base}/compile-cache/artifact"
        else:
            return web.json_response({"error": "unknown route"}, status=404)
        try:
            async with aiohttp.ClientSession() as session:
                async with session.request(
                    request.method, url, data=body,
                    timeout=aiohttp.ClientTimeout(total=10),
                ) as resp:
                    payload = await resp.read()
                    return web.Response(
                        body=payload, status=resp.status,
                        content_type=resp.content_type,
                    )
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            return web.json_response(
                {"error": f"fleet cache unreachable: {e}"}, status=502
            )

    app = web.Application()
    app.router.add_get("/counters", counters_handler)
    app.router.add_get("/metrics", metrics_handler)
    app.router.add_post("/push", push_handler)
    app.router.add_get("/compile-cache/{tail:.*}", cc_relay)
    app.router.add_post("/compile-cache/{tail:.*}", cc_relay)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "0.0.0.0", port)
    await site.start()
    log.info("metrics agent on :%d (%d cards)", port, len(nvml.inventory().cards))
    try:
        await stop.wait()
    finally:
        await runner.cleanup()


def main() -> None:
    base.setup_logging()
    port = int(os.environ.get("AGENT_PORT", "5555"))
    nvml.inventory()  # a node without NVML fails here, naming the library

    async def run() -> None:
        await serve(
            port,
            base.stop_event(),
            push_ttl=float(os.environ.get("WORKLOAD_PUSH_TTL", "300")),
        )

    asyncio.run(run())


if __name__ == "__main__":
    main()
