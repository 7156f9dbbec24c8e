"""Runtime prep, the host's preparation: port of
``tpu_operator/agents/runtime_prep.py``.

It sets the permissions (``DEVICE_PERMISSIONS``, 0666 by default) of the
cards' nodes NVML names (``/dev/nvidia<minor>``), of the driver's control
nodes that exist, and of the vfio group nodes; optionally reserves 1 GiB
hugepages (``HUGEPAGES_GB``); and writes ``runtime-prep-ready`` for the
device plugin's init gate, removed on shutdown.  Configuring the NVIDIA
container runtime's hook lies outside it, as outside the reference's.

A node whose cards are all bound for passthrough has no NVML to answer:
its card nodes are none, and its vfio groups are still prepared.

    python -m tpu_operator_torch.agents.runtime_prep
"""

from __future__ import annotations

import asyncio
import logging
import os

from tpu_operator_torch import hw, nvml
from tpu_operator_torch.agents import base
from tpu_operator_torch.deviceplugin.plugin import card_node, control_nodes
from tpu_operator_torch.validator import status

log = logging.getLogger("tpu_operator_torch.runtime_prep")


def device_nodes() -> list[str]:
    """The nodes to prepare: the cards' (by NVML's minor numbers), the
    control nodes, the vfio groups."""
    try:
        cards = [card_node(c.minor) for c in nvml.inventory().cards if not c.lost]
    except nvml.NvmlError as e:
        log.info("no NVML on this host (%s): preparing no card nodes", e)
        cards = []
    return [p for p in cards if os.path.exists(p)] + control_nodes() + hw.vfio_device_paths()


def prep() -> dict:
    perms = int(os.environ.get("DEVICE_PERMISSIONS", "0666"), 8)
    fixed = []
    for path in device_nodes():
        try:
            os.chmod(path, perms)
            fixed.append(path)
        except OSError as e:
            log.warning("chmod %s failed: %s", path, e)
    hugepages = os.environ.get("HUGEPAGES_GB")
    if hugepages:
        sysfs = os.path.join(hw.hw_root(), "sys", "kernel", "mm", "hugepages",
                             "hugepages-1048576kB")
        try:
            os.makedirs(sysfs, exist_ok=True)
            with open(os.path.join(sysfs, "nr_hugepages"), "w") as f:
                f.write(str(int(hugepages)))
        except OSError as e:
            log.warning("hugepages setup failed: %s", e)
    return {"devices": fixed, "permissions": oct(perms)}


async def run() -> None:
    result = prep()
    log.info("runtime prep: %s", result)
    status.write_ready("runtime-prep", result)
    stop = base.stop_event()
    try:
        await stop.wait()
    finally:
        status.clear("runtime-prep")


def main() -> None:
    base.setup_logging()
    asyncio.run(run())


if __name__ == "__main__":
    main()
