"""The runtime manager, an init container: port of
``tpu_operator/agents/runtime_manager.py``.

The handover before an upgrade of the node's runtime (the driver container
here): when the operator asks for one with the node annotation
``tpu.google.com/tpu-runtime-upgrade-requested``, it evicts the pods that
use the node's cards, waits for them to be gone, and clears the request.
Without the annotation it does nothing.  The slice manager evicts with the
same rule before it writes a new partition layout.

A pod uses the cards when a container requests or limits a resource named
``nvidia.com/gpu`` or ``nvidia.com/gpu-<shape>`` (a partition unit).  Pods
a DaemonSet owns (the operator's own operands) are kept unless ``force``
is set; the wait is keyed by UID, so a DaemonSet's same-named new pod does
not end it early.

    python -m tpu_operator_torch.agents.runtime_manager
"""

from __future__ import annotations

import asyncio
import logging
import os

from tpu_operator_torch import consts
from tpu_operator_torch.k8s.client import ApiClient, ApiError, Config
from tpu_operator_torch.utils import deep_get

log = logging.getLogger("tpu_operator_torch.runtime_manager")


def pod_requests_gpu(pod: dict) -> bool:
    """The pod asks for a card or a partition unit of cards."""
    for container in deep_get(pod, "spec", "containers", default=[]):
        for kind in ("requests", "limits"):
            resources = deep_get(container, "resources", kind, default={})
            if any(r.startswith(consts.GPU_RESOURCE) for r in resources):
                return True
    return False


async def evict_gpu_pods(client: ApiClient, node_name: str, force: bool, timeout: float) -> int:
    """Delete the node's pods that use its cards and wait, up to
    ``timeout`` seconds, until the pods deleted are gone; returns how many
    were deleted."""
    selector = f"spec.nodeName={node_name}"
    evicted: dict[tuple, str] = {}  # (namespace, name) -> uid of the pod deleted
    for pod in await client.list_items("", "Pod", field_selector=selector):
        if not pod_requests_gpu(pod):
            continue
        meta = pod["metadata"]
        if any(r.get("kind") == "DaemonSet" for r in meta.get("ownerReferences") or []) \
                and not force:
            continue
        await client.delete("", "Pod", meta["name"], meta.get("namespace"))
        evicted[(meta.get("namespace"), meta["name"])] = meta.get("uid", "")
        log.info("evicted GPU pod %s/%s", meta.get("namespace"), meta["name"])
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while evicted and loop.time() < deadline:
        live = {(p["metadata"].get("namespace"), p["metadata"]["name"]):
                p["metadata"].get("uid", "")
                for p in await client.list_items("", "Pod", field_selector=selector)}
        if all(live.get(key) != uid for key, uid in evicted.items()):
            break
        await asyncio.sleep(0.5)
    return len(evicted)


async def run() -> int:
    node_name = os.environ["NODE_NAME"]
    force = os.environ.get("DRAIN_USE_FORCE", "false").lower() in ("1", "true")
    timeout = float(os.environ.get("DRAIN_TIMEOUT_SECONDS", "300"))
    async with ApiClient(Config.from_env()) as client:
        try:
            node = await client.get("", "Node", node_name)
        except ApiError as e:
            log.error("cannot read node %s: %s", node_name, e)
            return 1
        annotations = deep_get(node, "metadata", "annotations", default={})
        if annotations.get(consts.UPGRADE_REQUESTED_ANNOTATION) not in ("true", "1"):
            log.info("no upgrade requested; nothing to do")
            return 0
        log.info("upgrade requested on %s; evicting GPU workloads", node_name)
        evicted = await evict_gpu_pods(client, node_name, force, timeout)
        # cleared, so the next restart is a plain boot
        await client.patch(
            "", "Node", node_name,
            {"metadata": {"annotations": {consts.UPGRADE_REQUESTED_ANNOTATION: None}}},
        )
        log.info("evicted %d pods; upgrade annotation cleared", evicted)
    return 0


def main() -> None:
    from tpu_operator_torch.agents import base

    base.setup_logging()
    raise SystemExit(asyncio.run(run()))


if __name__ == "__main__":
    main()
