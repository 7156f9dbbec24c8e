"""Host hardware truth for the node validator on an NVIDIA node: the port's
counterpart of ``tpu_operator/hw.py``.

The reference counts ``/dev/accel*`` and looks for ``libtpu.so``; here the
truth is the driver's per-card device nodes ``/dev/nvidia<N>`` and the
driver's user-space library (``libcuda.so.1``, or the versioned file it
links to).  Everything roots at ``TPU_HW_ROOT`` (default ``/``), so tests
present a synthetic host.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass


def hw_root() -> str:
    return os.environ.get("TPU_HW_ROOT", "/")


def _trailing_number(path: str) -> int:
    digits = ""
    for c in reversed(os.path.basename(path)):
        if c.isdigit():
            digits = c + digits
        else:
            break
    return int(digits) if digits else -1


# one node per card; nvidiactl, nvidia-uvm, nvidia-uvm-tools, nvidia-modeset
# and nvidia-caps/ are the driver's control nodes, not cards
_CARD_NODE = re.compile(r"nvidia[0-9]+")


def card_device_paths() -> list[str]:
    """The cards' device nodes, ``/dev/nvidia<N>``, in NUMERIC order:
    lexicographic order would put nvidia10 before nvidia2 on a host of more
    than ten cards."""
    paths = [
        p for p in glob.glob(os.path.join(hw_root(), "dev", "nvidia*"))
        if _CARD_NODE.fullmatch(os.path.basename(p))
    ]
    return sorted(paths, key=lambda p: (_trailing_number(p), p))


def vfio_device_paths() -> list[str]:
    """IOMMU group device nodes, in numeric group order."""
    paths = [
        p
        for p in glob.glob(os.path.join(hw_root(), "dev", "vfio", "*"))
        if os.path.basename(p) != "vfio"  # the container device, not a group
    ]
    return sorted(paths, key=lambda p: (_trailing_number(p), p))


NVIDIA_VENDOR = 0x10DE
VFIO_DRIVER = "vfio-pci"


@dataclass(frozen=True)
class PciFunction:
    address: str      # "0000:18:00.0", the sysfs name
    driver: str       # the bound driver's name, "" when none
    iommu_group: str  # the IOMMU group's number, "" when none


def is_card_function(vendor: int, pci_class: int) -> bool:
    """An NVIDIA card: vendor 0x10de and a display controller's class
    (0x03xxxx: VGA 0x0300, 3D 0x0302).  An HGX host's NVSwitches are vendor
    0x10de too, as bridges (0x0680xx): they are no card, and neither the
    device plugin nor the vfio manager may count or bind them."""
    return vendor == NVIDIA_VENDOR and pci_class >> 16 == 0x03


def pci_devices_dir() -> str:
    return os.path.join(hw_root(), "sys", "bus", "pci", "devices")


def _sysfs_number(path: str) -> int:
    with open(path) as f:
        return int(f.read().strip(), 16)


def _link_name(path: str) -> str:
    try:
        return os.path.basename(os.readlink(path))
    except OSError:
        return ""


def card_functions() -> list[PciFunction]:
    """The host's NVIDIA cards as PCI functions (sysfs under the hardware
    root), in address order, whatever driver holds them.  NVML orders its
    cards by PCI bus too, so the i-th function is NVML's card i while the
    driver holds them all."""
    devices = pci_devices_dir()
    try:
        addresses = sorted(os.listdir(devices))
    except OSError:
        return []
    out = []
    for addr in addresses:
        path = os.path.join(devices, addr)
        try:
            vendor = _sysfs_number(os.path.join(path, "vendor"))
            pci_class = _sysfs_number(os.path.join(path, "class"))
        except (OSError, ValueError):
            continue
        if is_card_function(vendor, pci_class):
            out.append(PciFunction(addr, _link_name(os.path.join(path, "driver")),
                                   _link_name(os.path.join(path, "iommu_group"))))
    return out


def vfio_cards() -> list[PciFunction]:
    """The cards bound to ``vfio-pci`` for passthrough, in address order: a
    VM host's inventory, since NVML cannot see a card the NVIDIA driver
    does not hold."""
    return [f for f in card_functions() if f.driver == VFIO_DRIVER]


def dev_dir() -> str:
    return os.path.join(hw_root(), "dev")


def vfio_group_path(group: str) -> str:
    return os.path.join(dev_dir(), "vfio", group)


def chip_count() -> int:
    """TPU_CHIP_COUNT env override → /dev/nvidia<N> count → 0."""
    env = os.environ.get("TPU_CHIP_COUNT")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return len(card_device_paths())


# where distributions and the GPU operator's driver container put the
# driver's libraries, relative to the host root
_DRIVER_LIB_DIRS = (
    "usr/lib/x86_64-linux-gnu",
    "usr/lib64",
    "usr/lib/aarch64-linux-gnu",
    "usr/lib",
    "run/nvidia/driver/usr/lib/x86_64-linux-gnu",
    "home/kubernetes/bin/nvidia/lib64",
    "usr/local/nvidia/lib64",
)


def _driver_library(stem: str) -> str:
    """The driver's library ``<stem>.so.1`` under its usual install
    locations beneath the hardware root, else the versioned file
    ``<stem>.so.<driver version>`` the driver installs (``.so.1`` is the
    loader's link to it, which a container may carry elsewhere or not at
    all); "" when neither is there."""
    root = hw_root()
    for rel in _DRIVER_LIB_DIRS:
        path = os.path.join(root, rel, stem + ".so.1")
        if os.path.exists(path):
            return path
    versioned_name = re.compile(re.escape(stem) + r"\.so\.[0-9][0-9.]*")
    for rel in _DRIVER_LIB_DIRS:
        versioned = sorted(p for p in glob.glob(os.path.join(root, rel, stem + ".so.*"))
                           if versioned_name.fullmatch(os.path.basename(p)))
        if versioned:
            return versioned[-1]
    return ""


def libcuda_path() -> str:
    """LIBCUDA_PATH env override → the driver's CUDA library beneath the
    hardware root; "" when no driver is installed."""
    env = os.environ.get("LIBCUDA_PATH")
    if env and os.path.exists(env):
        return env
    return _driver_library("libcuda")


def libnvml_path() -> str:
    """The driver's management library (NVML) beneath the hardware root,
    found as :func:`libcuda_path` finds ``libcuda``; "" when absent."""
    return _driver_library("libnvidia-ml")
