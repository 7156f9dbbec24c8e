"""The vfio manager: port of ``tpu_operator/agents/vfio_manager.py``, which
binds a host's chips to ``vfio-pci`` for VM passthrough.

It scans sysfs for the host's NVIDIA cards (``hw.card_functions``: vendor
``0x10de`` of a display controller's class; an HGX host's NVSwitches,
bridges of the same vendor, are never bound) and writes, for each, the
reference's ``driver_override`` (``vfio-pci``) and ``drivers_probe``
(its address).  A card already bound to ``vfio-pci`` is left as it is.

Everything roots at ``TPU_HW_ROOT``.  Under a root other than ``/`` no
kernel acts on the writes, so the bind is emulated there: the function's
``driver`` link points at ``vfio-pci`` and its group's node appears under
the root's ``/dev/vfio`` (numbered by the function's ``iommu_group``, or
as the reference numbers it when it has none).

    python -m tpu_operator_torch.agents.vfio_manager
"""

from __future__ import annotations

import asyncio
import logging
import os

from tpu_operator_torch import hw
from tpu_operator_torch.agents import base

log = logging.getLogger("tpu_operator_torch.vfio_manager")


def gpu_pci_addresses() -> list[str]:
    """The host's NVIDIA cards' PCI addresses, in address order."""
    return [f.address for f in hw.card_functions()]


def bind_to_vfio(addr: str) -> bool:
    """driver_override, then drivers_probe; False when a write fails."""
    root = hw.hw_root()
    path = os.path.join(hw.pci_devices_dir(), addr)
    function = next((f for f in hw.card_functions() if f.address == addr), None)
    if function is not None and function.driver == hw.VFIO_DRIVER:
        return True
    try:
        with open(os.path.join(path, "driver_override"), "w") as f:
            f.write(hw.VFIO_DRIVER)
        with open(os.path.join(root, "sys", "bus", "pci", "drivers_probe"), "w") as f:
            f.write(addr)
    except OSError as e:
        log.error("vfio bind %s failed: %s", addr, e)
        return False
    if root != "/":
        # no kernel under a synthetic root: do what it would
        group = (function.iommu_group if function is not None and function.iommu_group
                 else str(len(hw.vfio_device_paths())))
        os.makedirs(os.path.dirname(hw.vfio_group_path(group)), exist_ok=True)
        open(hw.vfio_group_path(group), "w").close()
        link = os.path.join(path, "driver")
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.join(root, "sys", "bus", "pci", "drivers", hw.VFIO_DRIVER), link)
    return True


async def run() -> None:
    addrs = gpu_pci_addresses()
    bound = [a for a in addrs if bind_to_vfio(a)]
    log.info("bound %d/%d NVIDIA cards to vfio-pci", len(bound), len(addrs))
    stop = base.stop_event()
    await stop.wait()


def main() -> None:
    base.setup_logging()
    asyncio.run(run())


if __name__ == "__main__":
    main()
