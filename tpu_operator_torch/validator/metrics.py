"""The validator's node-metrics mode on an NVIDIA node: port of
``tpu_operator/validator/metrics.py``, the gauges mirroring the status
files plus the host's device count, and the implementation behind the
node-status exporter.  The device count is the cards NVML lists, where the
reference counts ``/dev/accel*``; names, labels and help text are the
reference's, so the exposition is the same text.

:meth:`NodeMetrics.scrape` works on plain data; ``prometheus_client``
renders and ``aiohttp`` serves, each imported at its first use.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from tpu_operator_torch import consts, nvml
from tpu_operator_torch.validator import status

log = logging.getLogger("tpu_operator_torch.validator.metrics")


class NodeMetrics:
    # jax-payload key → exported metric label (set only when present)
    PERF_KEYS = {
        "algbw_gbps": "allreduce_gbps",
        "matmul_tflops": "matmul_tflops",
        "mfu": "mfu",
        "ring_link_gbps": "ring_link_gbps",
        "workers": "slice_workers",
        "allreduce_min_gbps": "allreduce_min_gbps",
        # the ring alert's floor: per LINK, never the allreduce floor
        "ring_min_gbps": "ring_min_gbps",
        "hbm_gbps": "hbm_gbps",
        # the DMA-pipeline cross-check: against hbm_gbps it isolates a
        # memory-system fault from a compute-pipeline one
        "hbm_dma_gbps": "hbm_dma_gbps",
        "hbm_fraction_of_peak": "hbm_fraction_of_peak",
    }

    def __init__(self, node_name: Optional[str] = None):
        # every series carries the NODE name (the DaemonSet injects it
        # through the downward API): Prometheus's `instance` is the scrape
        # endpoint, and runbooks need the node
        self.node_name = node_name or os.environ.get("NODE_NAME", "unknown")
        self.validation_status: dict[str, int] = {}
        self.device_count = 0
        self.perf: dict[str, float] = {}

    def scrape(self) -> None:
        """Re-read the status files and the card count.  Raises
        :class:`nvml.NvmlError` on a node without NVML."""
        self.validation_status = {c: int(status.is_ready(c)) for c in consts.STATUS_FILES}
        self.device_count = len(nvml.inventory().cards)
        payload = status.read_status("jax") or {}
        # the post-ready perf probes carry the matmul/hbm/ring figures in
        # their own status file; merge ONLY the measurement keys over the
        # jax payload (never its ok/error bookkeeping)
        perf = status.read_status("perf") or {}
        payload = {**payload, **{k: v for k, v in perf.items() if k in self.PERF_KEYS}}
        # re-derived each scrape: a metric absent from the CURRENT payload
        # must stop being served, not linger from an older round
        self.perf = {}

        def _set(metric: str, value) -> None:
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                self.perf[metric] = value

        for key, metric in self.PERF_KEYS.items():
            _set(metric, payload.get(key))
        ms = payload.get("multislice")
        if isinstance(ms, dict):
            _set("multislice_workers", ms.get("workers"))
            # the cross-slice figures under their own names
            _set("multislice_allreduce_gbps", ms.get("algbw_gbps"))
            _set("multislice_ring_link_gbps", ms.get("ring_link_gbps"))

    def render(self) -> bytes:
        """The last scrape in the Prometheus exposition format."""
        from prometheus_client import CollectorRegistry, Gauge, generate_latest

        registry = CollectorRegistry()
        validation = Gauge(
            "tpu_validator_validation_status",
            "1 when the component's validation status file is present",
            ["node", "component"], registry=registry,
        )
        devices = Gauge(
            "tpu_validator_tpu_device_count",
            "TPU chip device nodes visible on the host",
            ["node"], registry=registry,
        )
        perf = Gauge(
            "tpu_validator_measured",
            "Perf numbers measured by the last jax validation",
            ["node", "metric"], registry=registry,
        )
        for component, ready in self.validation_status.items():
            validation.labels(node=self.node_name, component=component).set(ready)
        devices.labels(node=self.node_name).set(self.device_count)
        for metric, value in self.perf.items():
            perf.labels(node=self.node_name, metric=metric).set(value)
        return generate_latest(registry)


async def serve_metrics(port: int, oneshot: bool = False, interval: float = 5.0) -> None:
    metrics = NodeMetrics()
    metrics.scrape()
    if oneshot:
        print(metrics.render().decode())
        return

    from aiohttp import web

    async def handler(request: web.Request) -> web.Response:
        metrics.scrape()
        return web.Response(body=metrics.render(), content_type="text/plain")

    app = web.Application()
    app.router.add_get("/metrics", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "0.0.0.0", port)
    await site.start()
    log.info("validator metrics serving on :%d", port)
    try:
        while True:
            await asyncio.sleep(interval)
    finally:
        await runner.cleanup()
