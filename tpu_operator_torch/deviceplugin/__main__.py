"""python -m tpu_operator_torch.deviceplugin [--mode accel|vfio]
[--slice-strategy none|single|mixed]

Serves ``nvidia.com/gpu`` to the kubelet and registers with it (port of
``python -m tpu_operator.deviceplugin``, with its flags).  ``--mode vfio``
serves the cards bound to ``vfio-pci`` for VMs (the sandbox plugin);
``--slice-strategy mixed`` (the ``SLICE_STRATEGY`` env) serves one
``nvidia.com/gpu-<shape>`` resource per partition shape of the slice
manager's layout, in either mode.  A node without NVML fails at start,
naming the library (vfio mode reads sysfs, not NVML).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.agents import base
from tpu_operator_torch.deviceplugin import sliceconfig
from tpu_operator_torch.deviceplugin.plugin import PluginConfig


def parse_config(argv: Optional[list] = None) -> tuple:
    """(slice strategy, the base plugin config) from the command line."""
    p = argparse.ArgumentParser("gpu-device-plugin")
    p.add_argument("--mode", choices=["accel", "vfio"], default="accel")
    p.add_argument("--resource-name", default=consts.GPU_RESOURCE)
    p.add_argument("--socket-name", default=None)
    p.add_argument(
        "--slice-strategy",
        choices=["none", "single", "mixed"],
        default=os.environ.get("SLICE_STRATEGY", "none") or "none",
    )
    args = p.parse_args(argv)
    socket = args.socket_name or (
        "nvidia-gpu-vfio.sock" if args.mode == "vfio" else "nvidia-gpu.sock")
    return args.slice_strategy, PluginConfig(resource_name=args.resource_name,
                                             socket_name=socket, mode=args.mode)


def main(argv: Optional[list] = None) -> int:
    base.setup_logging()
    strategy, config = parse_config(argv)
    asyncio.run(sliceconfig.run_plugins(strategy, config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
