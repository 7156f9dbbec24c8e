"""The slice manager, a per-node daemon: port of
``tpu_operator/agents/slice_manager.py`` (the MIG manager's counterpart).

It watches the node's ``google.com/tpu.slice.config`` label, resolves the
named profile against the slice-config ConfigMap's file, cuts the node's
mesh (``cloud.google.com/gke-tpu-topology``) into boxes of whole cards
(``tpu_operator_torch/slices.py``), evicts the pods that use the cards,
writes the layout to ``/run/tpu/slice_config.json`` (which the device
plugin's mixed strategy serves as one resource per shape), and reports
pending, then success or failed, in ``google.com/tpu.slice.config.state``.

A partition is a box of whole cards, never a part of one: MIG is not used.
A profile that does not tile the mesh sets ``failed`` and leaves the layout
file, and so the plugin set, as it was.  A pass is idempotent on the
resolved layout, not the profile's name: an edit of the ConfigMap under
the same name applies again.  Cards per host come from
``tpu.google.com/tpu.count`` (4 when absent, as the reference).

    python -m tpu_operator_torch.agents.slice_manager [--oneshot]
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Optional

from tpu_operator_torch import consts, slices
from tpu_operator_torch.agents import base
from tpu_operator_torch.agents.runtime_manager import evict_gpu_pods
from tpu_operator_torch.k8s.client import ApiClient, ApiError, Config
from tpu_operator_torch.utils import deep_get
from tpu_operator_torch.validator import status as vstatus

log = logging.getLogger("tpu_operator_torch.slice_manager")

STATE_PENDING = "pending"
STATE_SUCCESS = "success"
STATE_FAILED = "failed"


def read_applied() -> Optional[dict]:
    try:
        with open(vstatus.slice_config_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def write_applied(payload: dict) -> None:
    path = vstatus.slice_config_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)


def load_config(path: str) -> dict:
    """The ConfigMap's ``config.yaml``."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


class SliceManager:
    def __init__(self, client: ApiClient, node_name: str, config_file: str,
                 default_profile: str = "all-disabled"):
        self.client = client
        self.node_name = node_name
        self.config_file = config_file
        self.default_profile = default_profile

    async def set_state(self, value: str) -> None:
        await self.client.patch(
            "", "Node", self.node_name,
            {"metadata": {"labels": {consts.SLICE_CONFIG_STATE_LABEL: value}}},
        )

    async def sync_once(self) -> Optional[str]:
        """One reconcile pass; returns the state written, or None when the
        layout was already applied and reported."""
        node = await self.client.get("", "Node", self.node_name)
        labels = deep_get(node, "metadata", "labels", default={})
        profile = labels.get(consts.SLICE_CONFIG_LABEL, self.default_profile)
        try:
            accelerator = labels.get(consts.GKE_TPU_ACCELERATOR_LABEL, "")
            topology = labels.get(consts.GKE_TPU_TOPOLOGY_LABEL, "")
            try:
                chips_per_host = int(labels.get(consts.TPU_COUNT_LABEL, "4") or "4")
            except ValueError:
                chips_per_host = 4
            # the layout first, so idempotency compares partitions, not names
            shapes = slices.load_profile(load_config(self.config_file), profile,
                                         accelerator, topology)
            if shapes:
                if not topology:
                    raise slices.PartitionError("node has no ICI topology label")
                layout = slices.chip_assignments(topology, shapes, chips_per_host)
            else:
                layout = []  # the whole slice
            desired = {"profile": profile, "topology": topology, "partitions": layout}

            if read_applied() == desired:
                if labels.get(consts.SLICE_CONFIG_STATE_LABEL) != STATE_SUCCESS:
                    await self.set_state(STATE_SUCCESS)
                    return STATE_SUCCESS
                return None

            log.info("applying slice profile %r (topology %s)", profile, topology)
            await self.set_state(STATE_PENDING)
            # no pod may hold a card while the units it came from change
            await evict_gpu_pods(self.client, self.node_name, force=False, timeout=30)
            write_applied(desired)
            await self.set_state(STATE_SUCCESS)
            log.info("profile %r applied: %d partitions", profile, len(layout))
            return STATE_SUCCESS
        except (slices.PartitionError, ApiError, OSError, ValueError) as e:
            log.error("slice config failed: %s", e)
            await self.set_state(STATE_FAILED)
            return STATE_FAILED


async def run(oneshot: bool = False) -> None:
    node_name = os.environ["NODE_NAME"]
    config_file = os.environ.get("SLICE_CONFIG_FILE", "/slice-config/config.yaml")
    default_profile = os.environ.get("DEFAULT_SLICE_CONFIG", "all-disabled")
    interval = float(os.environ.get("SYNC_INTERVAL_SECONDS", "15"))
    async with ApiClient(Config.from_env()) as client:
        mgr = SliceManager(client, node_name, config_file, default_profile)
        if oneshot:
            await mgr.sync_once()
            return
        stop = base.stop_event()

        async def tick():
            try:
                await mgr.sync_once()
            except (ApiError, OSError) as e:
                log.warning("slice sync failed: %s", e)

        await base.run_periodic(tick, interval, stop)


def main() -> None:
    import sys

    base.setup_logging()
    asyncio.run(run(oneshot="--oneshot" in sys.argv))


if __name__ == "__main__":
    main()
