"""The node-status exporter on an NVIDIA node: port of
``tpu_operator/agents/node_status_exporter.py``: the validator's metrics
mode (``validator/metrics.py``) served, plus the **health verdict
publisher**.  The evidence this agent watches (validator status-file
regressions, the cards NVML lists, the metrics agent's scrape-error
counter) is judged into an ``ok``/``unhealthy`` verdict and published on
the node's ``tpu.google.com/tpu-health`` label with a reason code in the
paired annotation, with the reference's verdicts and reasons
(``validator-regressed:…``, ``no-devices``, ``chip-scrape-failed``).  The
operator's health engine consumes the verdict; this agent never actuates.

    NODE_NAME=<node> EXPORTER_PORT=8000 python -m tpu_operator_torch.agents.node_status_exporter
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from tpu_operator_torch import consts, nvml
from tpu_operator_torch.agents import base
from tpu_operator_torch.k8s.client import ApiClient, Config
from tpu_operator_torch.validator import status as vstatus
from tpu_operator_torch.validator.metrics import serve_metrics

log = logging.getLogger("tpu_operator_torch.node_status_exporter")

# env contract (DS template wires these; tests set them directly)
AGENT_COUNTERS_URL_ENV = "TPU_METRICS_AGENT_COUNTERS_URL"
HEALTH_PUBLISH_ENV = "TPU_HEALTH_PUBLISH"  # "0" disables the publisher
DEFAULT_AGENT_COUNTERS_URL = "http://127.0.0.1:5555/counters"

# components whose ready-marker REGRESSION (present → absent outside a
# deliberate re-validation) is a health signal; perf is report-only by
# design and runtime-prep churns during upgrades
_WATCHED_COMPONENTS = ("libtpu", "pjrt", "plugin", "jax")


class HealthAssessor:
    """Judges node-local evidence into one (verdict, reason) pair.

    Stateful on purpose: regressions are *transitions* (a component that
    was proven ready losing its marker; the scrape-error counter climbing),
    so the assessor remembers what it saw last round.  A node that never
    validated is NOT unhealthy — absence of proof is the validator's
    domain; this agent only reports proof being LOST."""

    def __init__(self) -> None:
        self._was_ready: set[str] = set()
        self._regressed: set[str] = set()
        self._last_scrape_errors: Optional[float] = None
        self._had_chips = False

    def assess(self, agent_counters: Optional[dict]) -> tuple[str, str]:
        reasons: list[str] = []

        # a regression ASSERTS until the component re-proves: the verdict
        # must stay unhealthy for as long as the proof is missing, not
        # report a one-shot transition and revert to ok while the node is
        # still broken (the engine's hysteresis needs the sustained state)
        ready = {c for c in _WATCHED_COMPONENTS if vstatus.is_ready(c)}
        self._regressed = (self._regressed | (self._was_ready - ready)) - ready
        self._was_ready = ready | self._regressed
        if self._regressed:
            reasons.append("validator-regressed:" + ",".join(sorted(self._regressed)))

        # likewise: cards WERE visible and are gone — asserted until they
        # return; never the steady state of a host that never had one
        chips = _card_count()
        self._had_chips = self._had_chips or chips > 0
        if chips == 0 and self._had_chips:
            reasons.append("no-devices")

        errors = _scrape_error_total(agent_counters)
        if errors is not None:
            if (
                self._last_scrape_errors is not None
                and errors > self._last_scrape_errors
            ):
                # genuinely transitional: a flat counter means scrapes
                # stopped failing, so this one clears on its own
                reasons.append("chip-scrape-failed")
            self._last_scrape_errors = errors

        if reasons:
            return consts.HEALTH_UNHEALTHY, ";".join(reasons)
        return consts.HEALTH_OK, ""


def _card_count() -> int:
    """The cards NVML lists; 0 when NVML stopped answering on a node that
    had cards (the driver gone is the cards gone, for this verdict)."""
    try:
        return len(nvml.inventory().cards)
    except nvml.NvmlError as e:
        log.warning("NVML inventory failed: %s", e)
        return 0


def _scrape_error_total(agent_counters: Optional[dict]) -> Optional[float]:
    """Sum of tpu_chip_scrape_errors_total across chips from the metrics
    agent's /counters snapshot; None when the agent is unreachable (the
    agent being down is an operand problem, not chip health evidence)."""
    if not isinstance(agent_counters, dict):
        return None
    chips = agent_counters.get("chips")
    if not isinstance(chips, dict):
        return None
    total = 0.0
    for counters in chips.values():
        try:
            total += float(
                (counters or {}).get("tpu_chip_scrape_errors_total", 0.0)
            )
        except (TypeError, ValueError):
            continue
    return total


class HealthPublisher:
    """Publishes the assessor's verdict onto the Node object, write-on-change
    only (steady state costs few API writes) — re-asserted every
    ``republish_every`` steps so a label stripped out-of-band (node object
    recreated by cloud repair, an admin's ``kubectl label ... tpu-health-``)
    cannot silence the signal plane until the verdict next changes."""

    REPUBLISH_EVERY = 24  # ≈2 min at the default 5s interval

    def __init__(
        self, client: ApiClient, node_name: str,
        republish_every: int = REPUBLISH_EVERY,
    ):
        self.client = client
        self.node_name = node_name
        self.assessor = HealthAssessor()
        self.republish_every = max(1, republish_every)
        self._published: Optional[tuple[str, str]] = None
        self._since_published = 0

    async def step(self, agent_counters: Optional[dict]) -> tuple[str, str]:
        verdict, reason = self.assessor.assess(agent_counters)
        self._since_published += 1
        if (
            (verdict, reason) != self._published
            or self._since_published >= self.republish_every
        ):
            await self.client.patch(
                "", "Node", self.node_name,
                {"metadata": {
                    "labels": {consts.TPU_HEALTH_LABEL: verdict},
                    "annotations": {
                        consts.TPU_HEALTH_REASON_ANNOTATION: reason or None,
                    },
                }},
            )
            changed = (verdict, reason) != self._published
            self._published = (verdict, reason)
            self._since_published = 0
            if changed:
                (log.warning if verdict == consts.HEALTH_UNHEALTHY else log.info)(
                    "published tpu-health=%s%s on %s",
                    verdict, f" ({reason})" if reason else "", self.node_name,
                )
        return verdict, reason


async def _fetch_agent_counters(url: str) -> Optional[dict]:
    import aiohttp

    try:
        async with aiohttp.ClientSession() as session:
            async with session.get(
                url, timeout=aiohttp.ClientTimeout(total=2)
            ) as resp:
                if resp.status != 200:
                    return None
                return await resp.json()
    except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
        return None


async def publish_health_loop(
    node_name: str, interval: float, stop: Optional[asyncio.Event] = None
) -> None:
    """Assess + publish every ``interval`` seconds until ``stop``.  API
    failures are logged and retried next round — the exporter's metrics
    serving must never die with the control plane."""
    client = ApiClient(Config.from_env())
    publisher = HealthPublisher(client, node_name)
    url = os.environ.get(AGENT_COUNTERS_URL_ENV, DEFAULT_AGENT_COUNTERS_URL)
    try:
        while stop is None or not stop.is_set():
            counters = await _fetch_agent_counters(url)
            try:
                await publisher.step(counters)
            except Exception as e:  # noqa: BLE001 — publish is best-effort
                log.warning("health publish failed (retrying): %s", e)
            if stop is None:
                await asyncio.sleep(interval)
            else:
                try:
                    await asyncio.wait_for(stop.wait(), timeout=interval)
                except asyncio.TimeoutError:
                    pass
    finally:
        await client.close()


def main() -> None:
    base.setup_logging()
    port = int(os.environ.get("EXPORTER_PORT", "8000"))
    interval = float(os.environ.get("SCRAPE_INTERVAL_SECONDS", "5"))

    async def run() -> None:
        node_name = os.environ.get("NODE_NAME", "")
        publish = os.environ.get(HEALTH_PUBLISH_ENV, "1") != "0" and node_name
        tasks = [asyncio.create_task(serve_metrics(port, interval=interval))]
        if publish:
            tasks.append(
                asyncio.create_task(publish_health_loop(node_name, interval))
            )
        else:
            log.info("health publisher disabled (no NODE_NAME or opted out)")
        # serve_metrics runs forever; if any task dies, surface it
        done, pending = await asyncio.wait(
            tasks, return_when=asyncio.FIRST_EXCEPTION
        )
        for t in pending:
            t.cancel()
        for t in done:
            t.result()

    asyncio.run(run())


if __name__ == "__main__":
    main()
