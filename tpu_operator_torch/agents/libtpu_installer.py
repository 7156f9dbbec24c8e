"""The runtime container's marker on an NVIDIA node: port of
``tpu_operator/agents/libtpu_installer.py``, which places libtpu on the
host and marks the runtime ready.

On the card the runtime is the NVIDIA driver, which the host or the
driver container installs.  This agent:

- copies a payload named by ``LIBTPU_SRC`` (a library the operand image
  carries) into ``/home/kubernetes/bin/nvidia/lib64``, where GKE's driver
  installer puts the driver's libraries and the validator looks for them,
  by the reference's rule: only when the directory's ``version`` stamp
  differs or the file is missing.  Nothing is imported to find a payload;
- stamps the version as ``<driver>-cuda<CUDA>`` from NVML, the same text
  as feature discovery's ``tpu.google.com/tpu.runtime.version`` label;
- counts ``chips``, the live cards NVML lists, and writes
  ``.libtpu-ctr-ready`` (which the validator's ``libtpu`` component gates
  on) only when there is one; a node where NVML fails or lists none stays
  up and unready.  The marker is removed on shutdown.

    python -m tpu_operator_torch.agents.libtpu_installer
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil

from tpu_operator_torch import consts, hw, nvml
from tpu_operator_torch.agents import base
from tpu_operator_torch.agents.feature_discovery import runtime_version
from tpu_operator_torch.validator import status

log = logging.getLogger("tpu_operator_torch.libtpu_installer")


def install_dir() -> str:
    return os.path.join(hw.hw_root(), "home", "kubernetes", "bin", "nvidia", "lib64")


def payload() -> str:
    """The library the image carries, ``LIBTPU_SRC``; "" when none."""
    src = os.environ.get("LIBTPU_SRC")
    return src if src and os.path.exists(src) else ""


def install() -> dict:
    """Place the payload and read the runtime's version and live cards;
    idempotent."""
    try:
        inventory = nvml.inventory()
        version = runtime_version(inventory)
        chips = sum(not c.lost for c in inventory.cards)
    except nvml.NvmlError as e:
        log.error("NVML: %s", e)
        version, chips = "", 0
    target_dir = install_dir()
    src = payload()
    target = os.path.join(target_dir, os.path.basename(src)) if src else ""
    installed = False
    if src and os.path.abspath(src) != os.path.abspath(target):
        os.makedirs(target_dir, exist_ok=True)
        version_file = os.path.join(target_dir, "version")
        try:
            with open(version_file) as f:
                current = f.read().strip()
        except OSError:
            current = ""
        if current != version or not os.path.exists(target):
            shutil.copyfile(src, target)
            with open(version_file, "w") as f:
                f.write(version)
            installed = True
    return {"target": target, "version": version, "chips": chips, "installed": installed}


async def run() -> None:
    result = install()
    log.info("runtime install: %s", result)
    if result["chips"] <= 0:
        # up but unready: the startup probe keeps the pod NotReady
        log.warning("no live card in NVML; not writing the readiness marker")
    else:
        status.write_marker(consts.LIBTPU_CTR_MARKER)
        log.info("runtime ready; marker written")
    stop = base.stop_event()
    try:
        await stop.wait()
    finally:
        try:
            os.remove(os.path.join(status.validation_dir(), consts.LIBTPU_CTR_MARKER))
        except OSError:
            pass


def main() -> None:
    base.setup_logging()
    asyncio.run(run())


if __name__ == "__main__":
    main()
