"""python -m tpu_operator_torch.deviceplugin [--slice-strategy none|single]

Serves ``nvidia.com/gpu`` to the kubelet and registers with it (port of
``python -m tpu_operator.deviceplugin``, with its flags).  ``--mode vfio``
(cards bound for passthrough) and ``--slice-strategy mixed`` go with the
slice manager, which this package does not have yet: both exit 2.  A node
without NVML fails at start, naming the library.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.agents import base
from tpu_operator_torch.deviceplugin import sliceconfig
from tpu_operator_torch.deviceplugin.plugin import PluginConfig

log = logging.getLogger("tpu_operator_torch.deviceplugin")


def main(argv: Optional[list] = None) -> int:
    base.setup_logging()
    p = argparse.ArgumentParser("gpu-device-plugin")
    p.add_argument("--mode", choices=["accel", "vfio"], default="accel")
    p.add_argument("--resource-name", default=consts.GPU_RESOURCE)
    p.add_argument("--socket-name", default="nvidia-gpu.sock")
    p.add_argument(
        "--slice-strategy",
        choices=["none", "single", "mixed"],
        default=os.environ.get("SLICE_STRATEGY", "none") or "none",
    )
    args = p.parse_args(argv)
    if args.mode == "vfio":
        log.error("--mode vfio goes with the slice manager and the vfio manager, which "
                  "this package does not have yet")
        return 2
    if args.slice_strategy == "mixed":
        log.error("%s", sliceconfig.NOT_PORTED)
        return 2
    config = PluginConfig(resource_name=args.resource_name, socket_name=args.socket_name)
    asyncio.run(sliceconfig.run_plugins(args.slice_strategy, config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
