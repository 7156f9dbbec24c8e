"""Feature discovery on an NVIDIA node: port of
``tpu_operator/agents/feature_discovery.py``, which labels chips per host
from ``/dev/accel*`` and the generation from the GKE accelerator label.

The reference's ``tpu.google.com/*`` keys, which the unchanged operator
reads, hold the cards' content, from NVML (``tpu_operator_torch/nvml.py``):

- ``tpu.chip``: the generation of the card's name (``k8s/nodeinfo``, e.g.
  ``h100-sxm``);
- ``tpu.chips-per-host``: the cards NVML lists;
- ``tpu.memory.hbm-gb``: the card's memory in GiB, rounded (80 on an H100
  80GB);
- ``tpu.runtime.version``: the driver's and its CUDA's versions,
  ``<driver>-cuda<cuda>``;
- ``tpu.ici.topology``, ``tpu.slice.hosts``, ``tpu.slice.worker-id``: the
  reference's rules on the GKE labels and ``TPU_WORKER_ID``.

It also sets ``nvidia.com/gpu.product``, the card's name with "-" for
spaces, which ``nodeinfo.generation_of_node`` and the warm-pool key read.

    python -m tpu_operator_torch.agents.feature_discovery [--oneshot]
"""

from __future__ import annotations

import asyncio
import json
import logging
import os

from tpu_operator_torch import consts, nvml
from tpu_operator_torch.agents import base
from tpu_operator_torch.k8s import nodeinfo
from tpu_operator_torch.k8s.client import ApiClient, Config
from tpu_operator_torch.utils import topology_chips

log = logging.getLogger("tpu_operator_torch.tfd")


def _labels(node: dict) -> dict:
    return (node.get("metadata") or {}).get("labels") or {}


def runtime_version(inventory: nvml.Inventory) -> str:
    """The driver's version and its CUDA's, as one label value (labels
    allow no "/")."""
    return f"{inventory.driver_version}-cuda{inventory.cuda_version}"


def discover_features(node: dict) -> dict[str, str]:
    """Compute the feature labels for this node."""
    labels = _labels(node)
    inventory = nvml.inventory()
    cards = inventory.cards
    chips = len(cards)
    name = cards[0].name if cards else ""
    out = {
        consts.TFD_CHIP_LABEL: nodeinfo.generation_of(name),
        consts.TFD_CHIPS_PER_HOST_LABEL: str(chips),
    }
    if name:
        out[consts.GPU_PRODUCT_LABEL] = name.replace(" ", "-")
    hbm = round(min(card.memory_total for card in cards) / 2**30) if cards else 0
    if hbm:
        out[consts.TFD_HBM_GB_LABEL] = str(hbm)
    topo = labels.get(consts.GKE_TPU_TOPOLOGY_LABEL, "")
    if topo:
        out[consts.TFD_ICI_TOPOLOGY_LABEL] = topo
        try:
            total = topology_chips(topo)
            if chips:
                out[consts.TFD_SLICE_HOSTS_LABEL] = str(max(1, total // chips))
        except ValueError:
            pass
    worker_id = os.environ.get("TPU_WORKER_ID") or labels.get(
        consts.GKE_TPU_WORKER_ID_LABEL, ""
    )
    if worker_id != "":
        out[consts.TFD_SLICE_WORKER_ID_LABEL] = str(worker_id)
    _write_worker_id_file(str(worker_id))
    out[consts.TFD_RUNTIME_VERSION_LABEL] = runtime_version(inventory)
    return out


def _write_worker_id_file(worker_id: str) -> None:
    """Drop the worker id beside /run/tpu/validations so node-local daemons
    without apiserver access (the device plugin's Allocate env) can read it.
    An empty id REMOVES the file: a node repurposed out of its multi-host
    slice must stop advertising a stale worker id (/run persists to reboot,
    not to relabel)."""
    from tpu_operator_torch.validator import status as vstatus

    path = vstatus.worker_id_path()
    if not os.path.isdir(os.path.dirname(path)):
        # /run/tpu is provisioned by the runtime DS mount on real nodes (and
        # by the TPU_VALIDATION_ROOT seam in tests); never create it here
        return
    try:
        if worker_id == "":
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            return
        with open(path, "w") as f:
            f.write(worker_id)
    except OSError as e:
        log.warning("could not update %s: %s", path, e)


async def label_node(client: ApiClient, node_name: str) -> dict[str, str]:
    node = await client.get("", "Node", node_name)
    features = discover_features(node)
    current = _labels(node)
    patch = {k: v for k, v in features.items() if current.get(k) != v}
    if patch:
        await client.patch("", "Node", node_name, {"metadata": {"labels": patch}})
        log.info("labelled %s: %s", node_name, patch)
    return features


async def run(oneshot: bool = False) -> None:
    node_name = os.environ["NODE_NAME"]
    interval = base.parse_duration(os.environ.get("TFD_SLEEP_INTERVAL", "60s"))
    nvml.inventory()  # a node without NVML fails here, naming the library
    stop = base.stop_event()
    async with ApiClient(Config.from_env()) as client:
        if oneshot:
            print(json.dumps(await label_node(client, node_name)))
            return

        async def tick():
            try:
                await label_node(client, node_name)
            except Exception as e:  # noqa: BLE001 — transient apiserver blips must not crash-loop the DS
                log.warning("feature labelling failed: %s", e)

        await base.run_periodic(tick, interval, stop)


def main() -> None:
    import sys

    base.setup_logging()
    asyncio.run(run(oneshot="--oneshot" in sys.argv))


if __name__ == "__main__":
    main()
