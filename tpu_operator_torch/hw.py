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
