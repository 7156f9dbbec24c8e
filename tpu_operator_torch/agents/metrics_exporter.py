"""The per-node Prometheus endpoint (DCGM-exporter analogue): port of
``tpu_operator/agents/metrics_exporter.py``.  Scrapes the metrics agent's
/counters JSON (AGENT_PORT), filters through the optional counter allowlist
CSV (METRICS_CONFIG_FILE, dcgm-exporter CSV convention: ``counter_name,
comment``), and re-exports with node/chip labels; with the agent down it
collects from NVML itself.

    EXPORTER_PORT=9400 AGENT_PORT=5555 python -m tpu_operator_torch.agents.metrics_exporter
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from tpu_operator_torch.agents import base
from tpu_operator_torch.agents.metrics_agent import collect, to_prometheus

log = logging.getLogger("tpu_operator_torch.metrics_exporter")


def load_allowlist(path: Optional[str]) -> Optional[set[str]]:
    """None → all counters; CSV rows 'counter, comment' → that subset."""
    if not path:
        return None
    allow: set[str] = set()
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                allow.add(line.split(",", 1)[0].strip())
    except OSError as e:
        log.warning("cannot read metrics config %s: %s; exporting all", path, e)
        return None
    return allow or None


def render(snapshot: dict, node: str, allow: Optional[set[str]]) -> str:
    return to_prometheus(snapshot, extra_labels={"node": node}, allow=allow)


async def fetch_snapshot(agent_port: int, session=None) -> dict:
    """Agent first (shared sampler); direct collection as fallback.

    ``session`` is the exporter's long-lived ClientSession — constructing
    one per scrape cost a TCP connect + TLS-less handshake every request
    and leaked pressure under Prometheus's default 15 s scrape interval.
    A bare call (tests, one-shots) still works without one."""
    import aiohttp

    try:
        if session is None:
            async with aiohttp.ClientSession() as one_shot:
                return await _fetch(one_shot, agent_port)
        return await _fetch(session, agent_port)
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
        return await collect()


async def _fetch(session, agent_port: int) -> dict:
    import aiohttp

    async with session.get(
        f"http://127.0.0.1:{agent_port}/counters",
        timeout=aiohttp.ClientTimeout(total=2),
    ) as resp:
        return await resp.json()


async def serve(port: int, agent_port: int, stop: asyncio.Event) -> None:
    import aiohttp
    from aiohttp import web

    node = os.environ.get("NODE_NAME", "")
    allow = load_allowlist(os.environ.get("METRICS_CONFIG_FILE"))

    async with aiohttp.ClientSession() as session:

        async def handler(request: web.Request) -> web.Response:
            snapshot = await fetch_snapshot(agent_port, session)
            return web.Response(
                text=render(snapshot, node, allow), content_type="text/plain"
            )

        app = web.Application()
        app.router.add_get("/metrics", handler)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "0.0.0.0", port)
        await site.start()
        log.info("metrics exporter on :%d (agent :%d)", port, agent_port)
        try:
            await stop.wait()
        finally:
            await runner.cleanup()


def main() -> None:
    base.setup_logging()

    async def run() -> None:
        await serve(
            int(os.environ.get("EXPORTER_PORT", "9400")),
            int(os.environ.get("AGENT_PORT", "5555")),
            base.stop_event(),
        )

    asyncio.run(run())


if __name__ == "__main__":
    main()
