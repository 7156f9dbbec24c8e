"""The plugin set a node runs, by slice strategy: port of
``tpu_operator/deviceplugin/sliceconfig.py``.

``none`` and ``single`` serve the one ``nvidia.com/gpu`` plugin over every
card (MIG-single semantics: a homogeneous partition still counts under the
flat resource).  ``mixed`` turns the slice manager's layout
(``/run/tpu/slice_config.json``, ``agents/slice_manager.py``) into one
plugin per partition shape, resource ``nvidia.com/gpu-<shape>``, each
device one partition unit: this host's share of one partition, taken whole
by one container.

A unit's local index *i* is the card at NVML's index *i* (PCI bus order),
never CUDA's (fastest first) nor the ``/dev`` number; in vfio mode it is
the *i*-th card bound to ``vfio-pci``, in address order, which is the
same order.  A layout that spans hosts, on a node with no worker id yet,
serves the flat plugin until the id arrives.  The reconcile is
incremental: a shape whose config did not change keeps its socket and its
registration across a repartition.  A plugin that fails (a node without
NVML) ends the process, which the DaemonSet restarts.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
from typing import Optional

from tpu_operator_torch import consts, hw, nvml
from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin, PluginConfig, read_worker_id
from tpu_operator_torch.utils import topology_chips
from tpu_operator_torch.validator import status as vstatus

log = logging.getLogger("tpu_operator_torch.deviceplugin")


def read_layout() -> Optional[dict]:
    """The applied slice layout, or None when absent or unreadable."""
    try:
        with open(vstatus.slice_config_path()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def host_chip_count(mode: str = "accel") -> int:
    """The cards this host holds: NVML's count (a card lost before it gave
    its UUID still counts, so the units keep their indices), or in vfio
    mode the cards bound to ``vfio-pci`` (NVML sees none of them).  Raises
    :class:`nvml.NvmlError` on a node without NVML."""
    if mode == "vfio":
        return len(hw.vfio_cards())
    inventory = nvml.inventory()
    return max(inventory.device_count, len(inventory.cards))


def config_signature(mode: str = "accel") -> str:
    """The reconcile's change key: the applied layout, this host's worker
    id and its card count (a worker id that arrives late, or cards that
    appear after the start, change which units this host owns)."""
    layout = read_layout()
    sig = json.dumps(layout, sort_keys=True) if layout else ""
    return f"{sig}|worker={read_worker_id()}|chips={host_chip_count(mode)}"


def host_units(
    layout: Optional[dict], worker_id: int, chips_per_host: int
) -> dict[str, list[list[int]]]:
    """{shape: [the local card indices of each unit on this host]}.  Global
    ids are row-major over the mesh; host h owns [h*chips_per_host,
    (h+1)*chips_per_host).  A partition that spans hosts gives one unit on
    each, and a multi-host workload takes one unit per worker pod."""
    out: dict[str, list[list[int]]] = {}
    if not layout:
        return out
    lo = worker_id * chips_per_host
    hi = lo + chips_per_host
    for part in layout.get("partitions") or []:
        local = [cid - lo for cid in part.get("chip_ids", []) if lo <= cid < hi]
        if local:
            out.setdefault(part["shape"], []).append(sorted(local))
    return out


def resource_name(shape: str) -> str:
    return f"{consts.GPU_RESOURCE}-{shape.lower()}"


def _layout_spans_hosts(layout: Optional[dict], chips_per_host: int) -> bool:
    """The layout is of a multi-host slice (worker identity decides which
    units this host owns): by its topology, else by its chip ids."""
    topo = (layout or {}).get("topology") or ""
    if topo:
        try:
            return topology_chips(topo) > chips_per_host
        except ValueError:
            pass
    return any(cid >= chips_per_host
               for part in (layout or {}).get("partitions") or []
               for cid in part.get("chip_ids", []))


def build_plugin_configs(strategy: str, base: Optional[PluginConfig] = None) -> list[PluginConfig]:
    """The plugin set this node runs now: the flat plugin, or under
    ``mixed`` with partitions on this host one plugin per shape."""
    base = base or PluginConfig()
    if strategy != "mixed":
        return [base]
    layout = read_layout()
    chips = max(1, host_chip_count(base.mode))
    worker = read_worker_id()
    if worker is None:
        if _layout_spans_hosts(layout, chips):
            # worker 0 would advertise another host's units on this host's
            # cards: the flat plugin until feature discovery gives the id
            log.warning("mixed strategy on a multi-host layout with no worker id yet; "
                        "serving the flat plugin until feature discovery provides one")
            return [base]
        worker = 0
    units = host_units(layout, worker, chips)
    if not units:
        return [base]
    suffix = "-vfio" if base.mode == "vfio" else ""
    return [dataclasses.replace(
        base, resource_name=resource_name(shape),
        socket_name=f"nvidia-gpu-{shape.lower()}{suffix}.sock",
        device_sets={f"gpu-{shape}-{k}": unit for k, unit in enumerate(unit_list)},
        device_shape=shape,
    ) for shape, unit_list in sorted(units.items())]


async def run_plugins(strategy: str, base: PluginConfig, poll_seconds: float = 10.0) -> None:
    """Serve the plugin set, reconciling it whenever the applied layout,
    the worker id or the card count changes; only the plugins whose config
    changed are stopped and started.  A plugin's failure ends this
    coroutine with its error."""
    running: dict[str, tuple[str, GPUDevicePlugin, asyncio.Task]] = {}

    def key(cfg: PluginConfig) -> str:
        return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)

    async def stop(resource: str) -> None:
        _, plugin, task = running.pop(resource)
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
        await plugin.stop()

    try:
        while True:
            # the signature first: a layout written during the reconcile
            # below must not be absorbed unseen
            signature = config_signature(base.mode) if strategy == "mixed" else ""
            desired = {c.resource_name: c for c in build_plugin_configs(strategy, base)}
            for resource in list(running):
                if resource not in desired or key(desired[resource]) != running[resource][0]:
                    log.info("plugin %s removed or changed; stopping it", resource)
                    await stop(resource)
            for resource, cfg in desired.items():
                if resource not in running:
                    plugin = GPUDevicePlugin(cfg)
                    running[resource] = (key(cfg), plugin,
                                         asyncio.create_task(plugin.run_forever()))
            log.info("serving %d plugin(s): %s", len(running), sorted(running))
            while True:
                done, _ = await asyncio.wait([task for _, _, task in running.values()],
                                             timeout=poll_seconds,
                                             return_when=asyncio.FIRST_COMPLETED)
                for task in done:
                    task.result()  # a plugin's failure ends the process
                    raise RuntimeError("a device plugin stopped serving")
                if strategy == "mixed" and config_signature(base.mode) != signature:
                    log.info("slice layout, worker id or card count changed; reconciling")
                    break
    finally:
        for resource in list(running):
            await stop(resource)
