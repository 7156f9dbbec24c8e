"""The device plugin for ``nvidia.com/gpu``: port of
``tpu_operator/deviceplugin/plugin.py``, which advertises ``google.com/tpu``
from ``/dev/accel*``.

Protocol (kubelet device-plugin v1beta1), as the reference's:

1. serve DevicePlugin on ``<kubelet dir>/nvidia-gpu.sock``;
2. Register with the kubelet's Registration service on ``kubelet.sock``;
3. stream the cards' health through ListAndWatch, answer Allocate with the
   cards' device nodes and env, and GetPreferredAllocation with the set of
   cards nearest each other.

What the card changes:

- The inventory is NVML's (``tpu_operator_torch/nvml.py``), not a glob of
  ``/dev``.  A device's id is its card's UUID, its node
  ``/dev/nvidia<minor>``: NVML's index, CUDA's index and the ``/dev``
  number need not agree, and a node may hold stale card nodes beside the
  live ones.
- Allocate maps each card's node and the driver's control nodes that exist
  (``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``), and sets
  ``NVIDIA_VISIBLE_DEVICES`` (the container runtime's selector, which also
  injects the driver's libraries) and ``CUDA_VISIBLE_DEVICES`` to the
  cards' UUIDs, in the place of ``TPU_VISIBLE_CHIPS``,
  ``TPU_CHIPS_PER_HOST_BOUNDS`` and ``TPU_RUNTIME_METRICS_PORTS``.  UUIDs,
  not indices: CUDA's default order is fastest first, and the runtime
  renumbers what a container sees.
- The preferred set minimises the summed PCIe distance NVML reports
  between the cards (``nvmlDeviceGetTopologyCommonAncestor``) in the place
  of the reference's ICI mesh distance.  NVLink does not enter it: on an
  NVSwitch host every pair of cards has the same NVLink bandwidth.

Partition units (``device_sets``, the mixed strategy's, from
``sliceconfig.py``): a device is one unit of whole cards, named
``gpu-<shape>-<k>``, its members the cards at the unit's NVML indices.  A
unit is Healthy only while every card in it is alive and has its node; one
lost card makes the whole unit Unhealthy, and no unit is ever served with
fewer cards.  A container takes at most one unit.  Its allocation names
the unit's UUIDs in NVML's order and carries no worker id.

``mode="vfio"`` (the sandbox plugin, for VMs): a card bound to
``vfio-pci`` is invisible to NVML, so the inventory is sysfs's
(``hw.vfio_cards``), a device's id its PCI address and its node
``/dev/vfio/<IOMMU group>``.  An allocation maps the group nodes and
``/dev/vfio/vfio`` and names the addresses in KubeVirt's
``PCI_RESOURCE_<resource>`` env, which a VM launcher reads, where the
reference puts chip indices in ``TPU_VISIBLE_CHIPS``.

Discovery, health, the snapshot, the allocation and the pick work on plain
data; ``grpc`` and the generated messages are imported only by the gRPC
handlers, ``serve()`` and ``register()``.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Optional, Union

from tpu_operator_torch import consts, hw, nvml

log = logging.getLogger("tpu_operator_torch.deviceplugin")

KUBELET_DIR = "/var/lib/kubelet/device-plugins"
KUBELET_SOCKET = "kubelet.sock"
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

# the driver's nodes a CUDA process opens beside its card's own
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


@dataclass
class PluginConfig:
    resource_name: str = consts.GPU_RESOURCE
    socket_name: str = "nvidia-gpu.sock"
    kubelet_dir: str = field(default_factory=lambda: os.environ.get("KUBELET_PLUGIN_DIR", KUBELET_DIR))
    health_interval: float = field(
        default_factory=lambda: float(os.environ.get("HEALTH_INTERVAL_SECONDS", "5"))
    )
    # CDI (container-device-interface), the reference's cdi sub-spec:
    # ``cdi_enabled`` maintains a CDI spec file under ``cdi_dir`` describing
    # every card; ``cdi_default`` answers Allocate with CDI device names (the
    # runtime injects the nodes from the spec) instead of DeviceSpecs.
    cdi_enabled: bool = field(
        default_factory=lambda: os.environ.get("CDI_ENABLED", "").lower() in ("1", "true")
    )
    cdi_default: bool = field(
        default_factory=lambda: os.environ.get("CDI_DEFAULT", "").lower() in ("1", "true")
    )
    cdi_dir: str = field(default_factory=lambda: os.environ.get("CDI_DIR", "/var/run/cdi"))
    mode: str = "accel"  # accel | vfio (the sandbox plugin)
    # the mixed strategy's partition units: unit id -> the local indices of
    # its cards (NVML's index in accel mode, the position among the
    # vfio-bound cards in vfio mode); None serves every card on its own
    device_sets: Optional[dict[str, list[int]]] = None
    device_shape: str = ""  # the units' partition shape, e.g. "1x2"

    @property
    def socket_path(self) -> str:
        return os.path.join(self.kubelet_dir, self.socket_name)

    @property
    def kubelet_socket_path(self) -> str:
        return os.path.join(self.kubelet_dir, KUBELET_SOCKET)


class UnknownDevice(KeyError):
    """Allocate named a device this plugin never advertised."""


class AllocationRefused(ValueError):
    """Allocate asked for what a partition unit cannot give: two units in
    one container, or a unit holding a card NVML never listed."""


# a device's member: a card NVML lists, or a card bound for passthrough
Member = Union[nvml.Card, hw.PciFunction]


def member_id(member: Member) -> str:
    return member.uuid if isinstance(member, nvml.Card) else member.address


def member_node(member: Member) -> str:
    """The host path of the member's own device node."""
    if isinstance(member, nvml.Card):
        return card_node(member.minor)
    return hw.vfio_group_path(member.iommu_group)


def pci_resource_env(resource_name: str) -> str:
    """KubeVirt's env naming a resource's PCI addresses
    (``nvidia.com/gpu`` -> ``PCI_RESOURCE_NVIDIA_COM_GPU``)."""
    return "PCI_RESOURCE_" + re.sub(r"[/.]", "_", resource_name.upper())


def card_node(minor: int) -> str:
    """The host path of the card with this minor number."""
    return os.path.join(hw.dev_dir(), f"nvidia{minor}")


def control_nodes() -> list[str]:
    """The driver's control nodes that exist on the host."""
    paths = [os.path.join(hw.dev_dir(), name) for name in CONTROL_NODES]
    return [p for p in paths if os.path.exists(p)]


def read_worker_id() -> Optional[int]:
    """This host's worker index within its multi-host slice: the
    TPU_WORKER_ID env (DaemonSet-injected) wins, else the ``worker_id`` file
    feature discovery drops beside the validations dir; None on single-host
    nodes with neither."""
    env = os.environ.get("TPU_WORKER_ID")
    if env is not None and env != "":
        try:
            return int(env)
        except ValueError:
            pass
    from tpu_operator_torch.validator import status as vstatus

    try:
        with open(vstatus.worker_id_path()) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


class GPUDevicePlugin:
    """The DevicePlugin service implementation + kubelet registration."""

    def __init__(self, config: Optional[PluginConfig] = None):
        self.config = config or PluginConfig()
        # device id (a UUID, a PCI address or a unit id) -> its members;
        # None stands for a unit's card NVML has never listed
        self.devices: dict[str, tuple] = {}
        self.health: dict[str, str] = {}
        # one queue per live ListAndWatch stream (broadcast, not steal)
        self._watchers: set[asyncio.Queue] = set()
        self._server = None
        self._health_task: Optional[asyncio.Task] = None

    # -- discovery / health -------------------------------------------
    def _inventory(self) -> list:
        """The cards this mode serves: NVML's, or the vfio-bound ones."""
        if self.config.mode == "vfio":
            return hw.vfio_cards()
        return list(nvml.inventory().cards)

    def _alive(self, member: Optional[Member], now: dict) -> bool:
        """The member is in the inventory ``now`` ({id: member}), not lost,
        and its node exists."""
        current = now.get(member_id(member)) if member is not None else None
        if current is None or getattr(current, "lost", False):
            return False
        if isinstance(current, hw.PciFunction) and not current.iommu_group:
            return False
        return os.path.exists(member_node(current))

    def refresh_devices(self) -> bool:
        """Re-read the inventory.  A card is Healthy while NVML lists it as
        alive and its node exists (in vfio mode: while it is bound to
        ``vfio-pci`` and its group node exists).  A device seen before
        that the inventory no longer lists, or that NVML answers "GPU is
        lost" for, or whose node vanished, stays advertised as Unhealthy
        (the kubelet's signal to fail pods bound to it) rather than
        silently dropping capacity."""
        current = self._inventory()
        now = {member_id(m): m for m in current}
        if self.config.device_sets is not None:
            devices = self._units(current)
        else:
            devices = {}
            for did, member in now.items():
                seen = self.devices.get(did)
                if getattr(member, "lost", False) and seen:
                    member = seen[0]  # a lost card no longer reports its minor number
                devices[did] = (member,)
            for did, members in self.devices.items():
                devices.setdefault(did, members)
        health = {did: HEALTHY if all(self._alive(m, now) for m in members) else UNHEALTHY
                  for did, members in devices.items()}
        changed = devices != self.devices or health != self.health
        self.devices, self.health = devices, health
        return changed

    def _units(self, current: list) -> dict[str, tuple]:
        """Each unit's members, resolved from its local indices the first
        time each card is seen and kept after (a lost or vanished card
        stays in its unit, which turns Unhealthy)."""
        if self.config.mode == "vfio":
            local = dict(enumerate(current))
        else:
            local = {card.index: card for card in current}
        units = {}
        for unit, indices in self.config.device_sets.items():
            seen = self.devices.get(unit) or (None,) * len(indices)
            members = []
            for index, old in zip(indices, seen):
                member = local.get(index)
                if old is not None and (member is None or member_id(member) != member_id(old)
                                        or getattr(member, "lost", False)):
                    member = old
                members.append(member)
            units[unit] = tuple(members)
        return units

    def _mark_all_unhealthy(self) -> bool:
        health = dict.fromkeys(self.devices, UNHEALTHY)
        changed = health != self.health
        self.health = health
        return changed

    def _cdi_spec_path(self) -> str:
        return os.path.join(
            self.config.cdi_dir, self.config.resource_name.replace("/", "-") + ".json"
        )

    def _shared_nodes(self) -> list[str]:
        """The nodes every allocation maps beside its devices' own: the
        driver's control nodes, or the VFIO container node."""
        if self.config.mode != "vfio":
            return control_nodes()
        container = hw.vfio_group_path("vfio")
        return [container] if os.path.exists(container) else []

    def write_cdi_spec(self) -> Optional[str]:
        """Converge the host CDI spec file describing every advertised
        device (named by its id, its members' nodes in its edits) and the
        nodes every allocation shares (in the spec-wide edits).  Returns the
        path, or None when CDI is disabled (a leftover spec from an earlier
        enablement is removed: an orphaned file would keep resolving
        requests against stale state).  Called every health tick, since nodes appear and vanish
        apart from the inventory; unchanged content is not rewritten."""
        path = self._cdi_spec_path()
        if not self.config.cdi_enabled:
            try:
                os.remove(path)
            except OSError:
                pass
            return None

        def node(host_path: str) -> dict:
            return {"path": f"/dev/{os.path.relpath(host_path, hw.dev_dir())}",
                    "hostPath": host_path, "permissions": "rw"}

        devices = []
        for did in sorted(self.devices):
            paths = [member_node(m) for m in self.devices[did] if m is not None]
            devices.append({"name": did, "containerEdits": {
                "deviceNodes": [node(p) for p in paths if os.path.exists(p)]}})
        spec: dict = {"cdiVersion": "0.6.0", "kind": self.config.resource_name,
                      "devices": devices}
        shared = self._shared_nodes()
        if shared:
            spec["containerEdits"] = {"deviceNodes": [node(p) for p in shared]}
        os.makedirs(self.config.cdi_dir, exist_ok=True)
        content = json.dumps(spec, indent=2)
        try:
            with open(path) as f:
                if f.read() == content:
                    return path
        except OSError:
            pass
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(content)
        os.replace(tmp, path)
        return path

    def snapshot(self) -> list[tuple[str, str]]:
        """[(device id, health)] in id order: what ListAndWatch sends."""
        return [(did, self.health.get(did, UNHEALTHY)) for did in sorted(self.devices)]

    def _snapshot(self):
        from tpu_operator_torch.deviceplugin import api_pb2

        resp = api_pb2.ListAndWatchResponse()
        for did, health in self.snapshot():
            resp.devices.append(api_pb2.Device(ID=did, health=health))
        return resp

    async def _health_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.health_interval)
            try:
                changed = self.refresh_devices()
            except nvml.NvmlError as e:
                # the driver stopped answering: no card can take a pod
                log.warning("NVML inventory failed (will retry): %s", e)
                changed = self._mark_all_unhealthy()
            # a transient host-fs error (ro cdi_dir, ENOSPC) must not kill
            # the loop: health refresh is what keeps the kubelet truthful
            try:
                self.write_cdi_spec()
            except OSError as e:
                log.warning("CDI spec write failed (will retry): %s", e)
            if changed:
                for queue in list(self._watchers):
                    queue.put_nowait(None)

    # -- allocation ----------------------------------------------------
    def _order(self, did: str) -> tuple:
        """Device order: a unit's number, a card's NVML index, a function's
        address; an id never advertised last."""
        members = self.devices.get(did)
        if not members:
            return (1 << 30, did)
        if self.config.device_sets is not None:
            return (hw._trailing_number(did), did)
        return (members[0].index if isinstance(members[0], nvml.Card) else 0, did)

    def preferred_allocation(
        self, available: list[str], must_include: list[str], size: int
    ) -> list[str]:
        """``size`` devices out of ``available``, ``must_include`` first.
        Cards: of every choice, the one whose cards are nearest each other,
        by the summed PCIe common-ancestor level of each pair (a pair NVML
        gives no level for counts as the farthest, across the system);
        among equals the lowest NVML indices.  Partition units and
        passthrough cards (NVML sees neither's links): the reference's
        contiguous window, the smallest span in device order."""
        chosen = list(must_include)
        pool = sorted((d for d in available if d not in chosen), key=self._order)
        need = size - len(chosen)
        if need <= 0:
            return chosen[:size]
        if need >= len(pool):
            return chosen + pool
        if self.config.device_sets is None and self.config.mode == "accel":
            levels = nvml.topology(chosen + pool)

            def spread(combo: tuple) -> int:
                return sum(levels.get(frozenset(pair), nvml.TOPOLOGY_SYSTEM)
                           for pair in itertools.combinations(chosen + list(combo), 2))

            return chosen + list(min(itertools.combinations(pool, need), key=spread))
        position = {did: i for i, did in enumerate(sorted(self.devices, key=self._order))}
        pos = [position.get(did, len(position)) for did in pool]
        start = min(range(len(pool) - need + 1), key=lambda i: pos[i + need - 1] - pos[i])
        return chosen + pool[start:start + need]

    def allocate(self, device_ids: list[str]) -> dict:
        """One container's allocation: ``{"envs", "devices": [(container
        path, host path, permissions)], "cdi_devices": [names]}``.  Raises
        :class:`UnknownDevice` for an id this plugin never advertised and
        :class:`AllocationRefused` for more than one partition unit."""
        for did in device_ids:
            if did not in self.devices:
                raise UnknownDevice(did)
        units = self.config.device_sets is not None
        if units and len(device_ids) > 1:
            # a unit is the isolation boundary; two do not merge into a
            # larger box
            raise AllocationRefused(
                f"{self.config.resource_name}: at most one partition unit per container "
                "(request a larger slice shape instead)")
        ids = sorted(device_ids, key=self._order)
        members = [m for did in ids for m in self.devices[did]]
        if None in members:
            raise AllocationRefused(f"{ids[0]} holds a card NVML never listed")
        # NVML's order for cards, the address order for passthrough
        members.sort(key=lambda m: (m.index, "") if isinstance(m, nvml.Card) else (0, m.address))
        use_cdi = self.config.cdi_enabled and self.config.cdi_default
        devices, cdi = [], []
        if use_cdi:
            cdi = [f"{self.config.resource_name}={did}" for did in ids]
        else:
            # a node that does not exist would fail the container's start
            paths = [member_node(m) for m in members] + self._shared_nodes()
            devices = [(f"/dev/{os.path.relpath(p, hw.dev_dir())}", p, "rw")
                       for p in paths if os.path.exists(p)]
        names = ",".join(member_id(m) for m in members)
        if self.config.mode == "vfio":
            envs = {pci_resource_env(self.config.resource_name): names}
        else:
            envs = {"NVIDIA_VISIBLE_DEVICES": names, "CUDA_VISIBLE_DEVICES": names}
        # the worker id describes multi-host slice membership, which holds
        # only for a full-host allocation of the flat resource
        if not units and ids and len(ids) == len(self.devices):
            wid = self.worker_id()
            if wid is not None:
                envs["TPU_WORKER_ID"] = str(wid)
        return {"envs": envs, "devices": devices, "cdi_devices": cdi}

    def worker_id(self) -> Optional[int]:
        return read_worker_id()

    # -- DevicePlugin service (async handlers wired by rpc.py) ---------
    async def GetDevicePluginOptions(self, request, context):
        from tpu_operator_torch.deviceplugin import api_pb2

        return api_pb2.DevicePluginOptions(
            pre_start_required=False, get_preferred_allocation_available=True
        )

    async def ListAndWatch(self, request, context):
        queue: asyncio.Queue = asyncio.Queue()
        self._watchers.add(queue)
        try:
            yield self._snapshot()
            while True:
                await queue.get()
                yield self._snapshot()
        finally:
            self._watchers.discard(queue)

    async def GetPreferredAllocation(self, request, context):
        from tpu_operator_torch.deviceplugin import api_pb2

        resp = api_pb2.PreferredAllocationResponse()
        for creq in request.container_requests:
            # NVML calls block: off the event loop that serves ListAndWatch
            picked = await asyncio.get_running_loop().run_in_executor(
                None,
                self.preferred_allocation,
                list(creq.available_deviceIDs),
                list(creq.must_include_deviceIDs),
                creq.allocation_size,
            )
            resp.container_responses.append(
                api_pb2.ContainerPreferredAllocationResponse(deviceIDs=picked)
            )
        return resp

    async def Allocate(self, request, context):
        import grpc

        from tpu_operator_torch.deviceplugin import api_pb2

        resp = api_pb2.AllocateResponse()
        for creq in request.container_requests:
            try:
                alloc = self.allocate(list(creq.devicesIDs))
            except UnknownDevice as e:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                    f"unknown device {e.args[0]}")
            except AllocationRefused as e:
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            cresp = api_pb2.ContainerAllocateResponse()
            for container_path, host_path, permissions in alloc["devices"]:
                cresp.devices.append(api_pb2.DeviceSpec(
                    container_path=container_path, host_path=host_path,
                    permissions=permissions))
            for name in alloc["cdi_devices"]:
                cresp.cdi_devices.append(api_pb2.CDIDevice(name=name))
            cresp.envs.update(alloc["envs"])
            resp.container_responses.append(cresp)
        return resp

    async def PreStartContainer(self, request, context):
        from tpu_operator_torch.deviceplugin import api_pb2

        return api_pb2.PreStartContainerResponse()

    # -- lifecycle -----------------------------------------------------
    async def serve(self) -> None:
        """(Re)start the DevicePlugin server; safe to call after a kubelet
        restart wiped the plugin dir (the old unlinked socket is replaced).
        Raises :class:`nvml.NvmlError` on a node without NVML."""
        import grpc.aio

        from tpu_operator_torch.deviceplugin import rpc

        if self._server is not None:
            await self.stop()
        self.refresh_devices()
        self.write_cdi_spec()
        os.makedirs(self.config.kubelet_dir, exist_ok=True)
        try:
            os.remove(self.config.socket_path)
        except OSError:
            pass
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((rpc.device_plugin_handler(self),))
        self._server.add_insecure_port(f"unix://{self.config.socket_path}")
        await self._server.start()
        self._health_task = asyncio.create_task(self._health_loop())
        log.info(
            "device plugin serving %d %s devices on %s",
            len(self.devices), self.config.resource_name, self.config.socket_path,
        )

    async def register(self) -> None:
        """Register with the kubelet (retried by the caller on failure)."""
        import grpc.aio

        from tpu_operator_torch.deviceplugin import api_pb2, rpc

        async with grpc.aio.insecure_channel(
            f"unix://{self.config.kubelet_socket_path}"
        ) as channel:
            stub = rpc.RegistrationStub(channel)
            await stub.Register(
                api_pb2.RegisterRequest(
                    version=rpc.API_VERSION,
                    endpoint=self.config.socket_name,
                    resource_name=self.config.resource_name,
                    options=api_pb2.DevicePluginOptions(
                        get_preferred_allocation_available=True
                    ),
                )
            )
        log.info("registered %s with kubelet", self.config.resource_name)

    async def stop(self) -> None:
        # specs are removed on shutdown so no orphaned file keeps resolving
        # against a dead inventory (re-serve rewrites it)
        if self.config.cdi_enabled:
            try:
                os.remove(self._cdi_spec_path())
            except OSError:
                pass
        if self._health_task:
            self._health_task.cancel()
            try:
                await self._health_task
            except (asyncio.CancelledError, Exception):
                pass
            self._health_task = None
        if self._server:
            await self._server.stop(grace=1.0)
            self._server = None

    async def run_forever(self) -> None:
        """serve + register, re-serving AND re-registering after a kubelet
        restart: the kubelet wipes its device-plugins dir on startup, so the
        plugin socket must be recreated on disk, not just re-registered
        (restart detected via kubelet.sock inode change / plugin socket
        disappearance)."""
        await self.serve()
        while True:
            if not os.path.exists(self.config.socket_path):
                log.info("plugin socket removed (kubelet restart); re-serving")
                await self.serve()
            try:
                await self.register()
            except Exception as e:  # noqa: BLE001
                log.warning("kubelet registration failed (%s); retrying", e)
                await asyncio.sleep(5)
                continue
            try:
                ino = os.stat(self.config.kubelet_socket_path).st_ino
            except OSError:
                ino = None
            while True:
                await asyncio.sleep(self.config.health_interval)
                if not os.path.exists(self.config.socket_path):
                    break
                try:
                    if os.stat(self.config.kubelet_socket_path).st_ino != ino:
                        log.info("kubelet socket changed; re-registering")
                        break
                except OSError:
                    break
