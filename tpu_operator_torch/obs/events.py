"""Kubernetes Events from the node validator: own copy of the part of
``tpu_operator/obs/events.py`` the validator posts (a Warning on the Node
when a component fails or a measured figure regressed).

Posting is best-effort: an Event that cannot be written never fails a
validation.  The reference's in-process dedup (count bumps on repeats)
serves a long-running operator; a validator process posts once per failed
run, so every post here is a new Event.
"""

from __future__ import annotations

import datetime
import logging
import uuid
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.obs import trace as obs_trace

log = logging.getLogger("tpu_operator_torch.obs.events")

TYPE_WARNING = "Warning"

REASON_VALIDATION_FAILED = "ValidationFailed"
REASON_PERF_REGRESSED = "WorkloadPerfRegressed"


def node_ref(name: str) -> dict:
    """Minimal involvedObject for a Node event when only the name is at hand."""
    return {"apiVersion": "v1", "kind": "Node", "metadata": {"name": name}}


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class EventRecorder:
    def __init__(self, client, namespace: str, component: str = "tpu-validator"):
        self.client = client
        self.namespace = namespace
        self.component = component

    async def warning(self, involved: dict, reason: str, message: str) -> Optional[dict]:
        """Post a Warning Event; never raises."""
        try:
            return await self._post(involved, TYPE_WARNING, reason, message)
        except Exception as e:  # noqa: BLE001 — evidence, never control flow
            log.warning("dropped event %s/%s: %s", TYPE_WARNING, reason, e)
            return None

    async def _post(self, involved: dict, type_: str, reason: str, message: str) -> dict:
        meta = involved.get("metadata", {}) or {}
        uid = meta.get("uid", "")
        if not uid and involved.get("kind") and meta.get("name"):
            try:
                api_version = involved.get("apiVersion", "")
                group = api_version.split("/", 1)[0] if "/" in api_version else ""
                live = await self.client.get(
                    group, involved["kind"], meta["name"], meta.get("namespace"))
                uid = (live.get("metadata") or {}).get("uid", "")
            except Exception as e:  # noqa: BLE001 — the Event goes out without a uid
                log.debug("could not resolve uid for event ref %s: %s", meta.get("name"), e)
        tid = obs_trace.trace_id()
        now = _now()
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                "name": f"{meta.get('name', 'unknown')}.{uuid.uuid4().hex[:10]}",
                "namespace": self.namespace,
                **({"annotations": {consts.EVENT_TRACE_ID_ANNOTATION: tid}} if tid else {}),
            },
            "involvedObject": {
                "apiVersion": involved.get("apiVersion", ""),
                "kind": involved.get("kind", ""),
                "name": meta.get("name", ""),
                "namespace": meta.get("namespace", ""),
                "uid": uid,
            },
            "type": type_,
            "reason": reason,
            "message": message[:1024],
            "source": {"component": self.component},
            "reportingComponent": self.component,
            "firstTimestamp": now,
            "lastTimestamp": now,
            "count": 1,
        }
        return await self.client.create(event)
