"""The config manager, the device plugin's sidecar: port of
``tpu_operator/agents/config_manager.py``.

A ConfigMap holds named plugin configs; each node picks one with its
``tpu.google.com/device-plugin.config`` label (``DEFAULT_CONFIG`` when it
has none).  The sidecar writes the pick to ``/config/config.yaml`` and
keeps it current as the label or the ConfigMap changes; the file is
rewritten only when its content changes.  It does not set a card's power,
clocks or ECC.

    python -m tpu_operator_torch.agents.config_manager [--oneshot]
"""

from __future__ import annotations

import asyncio
import logging
import os

from tpu_operator_torch import consts
from tpu_operator_torch.agents import base
from tpu_operator_torch.k8s.client import ApiClient, ApiError, Config
from tpu_operator_torch.utils import deep_get

log = logging.getLogger("tpu_operator_torch.config_manager")

NODE_CONFIG_LABEL = consts.DEVICE_PLUGIN_CONFIG_LABEL
TARGET = "/config/config.yaml"


async def sync_once(client: ApiClient, node_name: str, cm_name: str, namespace: str,
                    default: str, target: str) -> str:
    """Write the node's pick to ``target``; returns its name."""
    node = await client.get("", "Node", node_name)
    selected = deep_get(node, "metadata", "labels", default={}).get(NODE_CONFIG_LABEL, default)
    cm = await client.get("", "ConfigMap", cm_name, namespace)
    data = cm.get("data") or {}
    key = selected if selected in data else f"{selected}.yaml"
    if key not in data:
        raise ApiError(404, "NotFound", f"config {selected!r} not in ConfigMap {cm_name}")
    content = data[key]
    os.makedirs(os.path.dirname(target), exist_ok=True)
    try:
        with open(target) as f:
            current = f.read()
    except OSError:
        current = None
    if current != content:
        with open(target, "w") as f:
            f.write(content)
        log.info("wrote config %r (%d bytes) to %s", selected, len(content), target)
    return selected


async def run(oneshot: bool) -> int:
    node_name = os.environ["NODE_NAME"]
    cm_name = os.environ["CONFIG_MAP_NAME"]
    namespace = os.environ.get(consts.OPERATOR_NAMESPACE_ENV, "tpu-operator")
    default = os.environ.get("DEFAULT_CONFIG", "default")
    target = os.environ.get("CONFIG_TARGET", TARGET)
    interval = float(os.environ.get("SYNC_INTERVAL_SECONDS", "15"))
    async with ApiClient(Config.from_env()) as client:
        if oneshot:
            await sync_once(client, node_name, cm_name, namespace, default, target)
            return 0
        stop = base.stop_event()

        async def tick():
            try:
                await sync_once(client, node_name, cm_name, namespace, default, target)
            except (ApiError, OSError) as e:
                log.warning("config sync failed: %s", e)

        await base.run_periodic(tick, interval, stop)
    return 0


def main() -> None:
    import sys

    base.setup_logging()
    raise SystemExit(asyncio.run(run(oneshot="--oneshot" in sys.argv)))


if __name__ == "__main__":
    main()
