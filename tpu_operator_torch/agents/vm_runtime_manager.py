"""The VM runtime manager: own copy of
``tpu_operator/agents/vm_runtime_manager.py`` (the kata manager's
counterpart).  It stages the containerd side of the VM-isolation runtime:
one runtime-handler drop-in per configured class under the host's
containerd ``conf.d``, kept converged, stale ones pruned.  The operator
renders the RuntimeClass objects.  The drop-ins are byte-identical to the
reference's, so either package's agent converges the other's files.

Everything roots at ``TPU_HW_ROOT``.  The agent never restarts containerd.

Env (DaemonSet-injected):
  VM_RUNTIME_CLASSES     comma list of ``name=handler`` pairs
  VM_RUNTIME_CONFIG_DIR  containerd drop-in dir (default /etc/containerd/conf.d)

    python -m tpu_operator_torch.agents.vm_runtime_manager
"""

from __future__ import annotations

import asyncio
import logging
import os

from tpu_operator_torch import hw
from tpu_operator_torch.agents import base

log = logging.getLogger("tpu_operator_torch.vm_runtime_manager")

MARKER = "vm-runtime-staged"


def parse_classes(env: str) -> list[tuple[str, str]]:
    """'kata-tpu=kata-tpu,fast=kata-clh' -> [(name, handler), ...]; an
    entry without '=' uses its name as the handler."""
    out = []
    for item in env.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, handler = item.partition("=")
        out.append((name, handler or name))
    return out


def handler_config(handler: str) -> str:
    """One class's containerd drop-in: a v2 runtime named ``handler`` on
    the kata shim, pod annotations passed through to the VM."""
    return (
        "version = 2\n"
        f'[plugins."io.containerd.grpc.v1.cri".containerd.runtimes.{handler}]\n'
        '  runtime_type = "io.containerd.kata.v2"\n'
        '  privileged_without_host_devices = true\n'
        "  pod_annotations = [\"tpu.google.com/*\"]\n"
    )


def config_path(config_dir: str, handler: str) -> str:
    return os.path.join(hw.hw_root(), config_dir.lstrip("/"), f"tpu-vm-runtime-{handler}.toml")


def stage(classes: list[tuple[str, str]], config_dir: str) -> int:
    """Converge one drop-in per handler and prune the operator's others
    (``tpu-vm-runtime-*``); returns how many files changed."""
    directory = os.path.join(hw.hw_root(), config_dir.lstrip("/"))
    os.makedirs(directory, exist_ok=True)
    desired = {os.path.basename(config_path(config_dir, handler)): handler_config(handler)
               for _, handler in classes}
    changed = 0
    for name, content in desired.items():
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                if f.read() == content:
                    continue
        except OSError:
            pass
        # containerd may reload conf.d mid-write: tmp + rename
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(content)
        os.replace(tmp, path)
        changed += 1
        log.info("staged containerd runtime config %s", path)
    for name in os.listdir(directory):
        if name.startswith("tpu-vm-runtime-") and name not in desired:
            os.remove(os.path.join(directory, name))
            changed += 1
            log.info("pruned stale runtime config %s", name)
    return changed


async def run() -> None:
    from tpu_operator_torch.validator import status

    classes = parse_classes(os.environ.get("VM_RUNTIME_CLASSES", "kata-tpu=kata-tpu"))
    config_dir = os.environ.get("VM_RUNTIME_CONFIG_DIR", "/etc/containerd/conf.d")
    interval = base.parse_duration(os.environ.get("VM_RUNTIME_INTERVAL", "60s"))
    stop = base.stop_event()

    def converge() -> None:
        # a transient host-filesystem error retries next tick
        try:
            stage(classes, config_dir)
            status.write_marker(MARKER)
        except OSError as e:
            log.warning("vm-runtime staging failed (will retry): %s", e)

    await base.run_periodic(converge, interval, stop)


def main() -> None:
    base.setup_logging()
    asyncio.run(run())


if __name__ == "__main__":
    main()
