"""The port's device plugin (``nvidia.com/gpu``) against the reference's
(``google.com/tpu``) on the same synthetic host, each over real gRPC unix
sockets through the reference's fake kubelet: the reference sees
``/dev/accel0..3``, the port ``/dev/nvidia0..3`` with a four-card NVML
inventory put in place of the library's."""

import asyncio
import json
import os

import grpc
import pytest

from tpu_operator.deviceplugin import api_pb2, rpc
from tpu_operator.deviceplugin.plugin import PluginConfig as JConfig
from tpu_operator.deviceplugin.plugin import TPUDevicePlugin
from tpu_operator.testing.fakekubelet import FakeKubelet
from tpu_operator_torch import nvml
from tpu_operator_torch.deviceplugin import __main__ as plugin_main
from tpu_operator_torch.deviceplugin import sliceconfig
from tpu_operator_torch.deviceplugin.plugin import (HEALTHY, UNHEALTHY, GPUDevicePlugin,
                                                   PluginConfig, UnknownDevice)

NAME = "NVIDIA H100 80GB HBM3"


def card(index: int, minor: int = None, lost: bool = False) -> nvml.Card:
    return nvml.Card(index, f"GPU-{index:08x}-7bd2-4c4e-9a3b-{index:012x}",
                     index if minor is None else minor, NAME, 85520809984, lost)


def inventory(cards) -> nvml.Inventory:
    return nvml.Inventory(tuple(cards), "570.124.06", "12.8")


# PCIe distances of the four fake cards: 0-1 and 2-3 share a switch, the
# pairs meet at the NUMA node
LEVELS = {frozenset((0, 1)): 10, frozenset((2, 3)): 10}


def fake_topology(uuids):
    index = {c.uuid: c.index for c in map(card, range(8))}
    return {frozenset((a, b)): LEVELS.get(frozenset((index[a], index[b])), 40)
            for i, a in enumerate(uuids) for b in uuids[i + 1:]}


@pytest.fixture
def host(tmp_path, monkeypatch):
    """One synthetic host for both packages: four accel nodes, four card
    nodes, two of the driver's control nodes."""
    dev = tmp_path / "hw" / "dev"
    dev.mkdir(parents=True)
    for i in range(4):
        (dev / f"accel{i}").touch()
        (dev / f"nvidia{i}").touch()
    (dev / "nvidiactl").touch()
    (dev / "nvidia-uvm").touch()
    monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path / "hw"))
    cards = [card(i) for i in range(4)]
    monkeypatch.setattr(nvml, "inventory", lambda: inventory(cards))
    monkeypatch.setattr(nvml, "topology", fake_topology)
    return tmp_path


def plugins(tmp_path, **kw):
    kubelet_dir = str(tmp_path / "kubelet")
    ref = TPUDevicePlugin(JConfig(kubelet_dir=kubelet_dir, health_interval=0.05, **kw))
    port = GPUDevicePlugin(PluginConfig(kubelet_dir=kubelet_dir, health_interval=0.05, **kw))
    return ref, port


def uuid(i: int) -> str:
    return card(i).uuid


async def _allocate(kubelet, endpoint, ids):
    async with kubelet.plugin_channel(endpoint) as channel:
        req = api_pb2.AllocateRequest()
        req.container_requests.append(api_pb2.ContainerAllocateRequest(devicesIDs=ids))
        return (await rpc.DevicePluginStub(channel).Allocate(req)).container_responses[0]


async def test_register_and_list_and_watch_match_reference(host):
    ref, port = plugins(host)
    async with FakeKubelet(port.config.kubelet_dir) as kubelet:
        await ref.serve()
        await port.serve()
        try:
            await ref.register()
            await port.register()
            jreg, treg = kubelet.registrations
            assert (jreg.version, treg.version) == ("v1beta1", "v1beta1")
            assert (treg.resource_name, treg.endpoint) == ("nvidia.com/gpu", "nvidia-gpu.sock")
            assert jreg.resource_name == "google.com/tpu"
            assert treg.options.get_preferred_allocation_available

            streams = {}
            channels = [kubelet.plugin_channel("tpu.sock"),
                        kubelet.plugin_channel("nvidia-gpu.sock")]
            for key, channel in zip(("ref", "port"), channels):
                streams[key] = rpc.DevicePluginStub(channel).ListAndWatch(api_pb2.Empty())
            first = {k: await asyncio.wait_for(s.read(), timeout=5) for k, s in streams.items()}
            assert len(first["ref"].devices) == len(first["port"].devices) == 4
            assert [d.ID for d in first["port"].devices] == sorted(uuid(i) for i in range(4))
            assert all(d.health == "Healthy" for r in first.values() for d in r.devices)

            # the third device's node disappears: still advertised, Unhealthy
            os.remove(os.path.join(os.environ["TPU_HW_ROOT"], "dev", "accel3"))
            os.remove(os.path.join(os.environ["TPU_HW_ROOT"], "dev", "nvidia3"))
            update = {k: await asyncio.wait_for(s.read(), timeout=5) for k, s in streams.items()}
            jhealth = {d.ID: d.health for d in update["ref"].devices}
            thealth = {d.ID: d.health for d in update["port"].devices}
            assert jhealth["tpu-accel3"] == thealth[uuid(3)] == "Unhealthy"
            assert sorted(jhealth.values()) == sorted(thealth.values())
            for channel in channels:
                await channel.close()
        finally:
            await ref.stop()
            await port.stop()


async def test_reserve_after_kubelet_wipe_matches_reference(host):
    ref, port = plugins(host)
    for plugin in (ref, port):
        await plugin.serve()
    try:
        for plugin in (ref, port):
            os.remove(plugin.config.socket_path)
            await plugin.serve()  # re-serve over the wiped dir
        async with FakeKubelet(port.config.kubelet_dir) as kubelet:
            for endpoint in ("tpu.sock", "nvidia-gpu.sock"):
                async with kubelet.plugin_channel(endpoint) as channel:
                    opts = await rpc.DevicePluginStub(channel).GetDevicePluginOptions(
                        api_pb2.Empty())
                    assert opts.get_preferred_allocation_available
    finally:
        await ref.stop()
        await port.stop()


async def test_allocate_matches_reference(host, monkeypatch):
    ref, port = plugins(host)
    await ref.serve()
    await port.serve()
    root = os.environ["TPU_HW_ROOT"]
    try:
        async with FakeKubelet(port.config.kubelet_dir) as kubelet:
            jresp = await _allocate(kubelet, "tpu.sock", ["tpu-accel1", "tpu-accel2"])
            tresp = await _allocate(kubelet, "nvidia-gpu.sock", [uuid(2), uuid(1)])
            jpaths = [d.host_path for d in jresp.devices]
            tpaths = [d.host_path for d in tresp.devices]
            controls = [os.path.join(root, "dev", n) for n in ("nvidiactl", "nvidia-uvm")]
            # one spec per card in both, plus the control nodes that exist
            assert len(jpaths) == 2 and len(tpaths) == 2 + len(controls)
            assert tpaths == [os.path.join(root, "dev", "nvidia1"),
                              os.path.join(root, "dev", "nvidia2"), *controls]
            assert [d.container_path for d in tresp.devices] == [
                "/dev/nvidia1", "/dev/nvidia2", "/dev/nvidiactl", "/dev/nvidia-uvm"]
            assert all(d.permissions == "rw" for d in [*jresp.devices, *tresp.devices])
            visible = f"{uuid(1)},{uuid(2)}"
            assert dict(tresp.envs) == {"CUDA_VISIBLE_DEVICES": visible,
                                        "NVIDIA_VISIBLE_DEVICES": visible}
            assert "TPU_WORKER_ID" not in jresp.envs

            # a full-host request on a multi-host slice: the worker id from
            # the file feature discovery drops under /run/tpu, in both
            run_tpu = host / "run_tpu"
            (run_tpu / "validations").mkdir(parents=True)
            (run_tpu / "worker_id").write_text("3")
            monkeypatch.setenv("TPU_VALIDATION_ROOT", str(run_tpu))
            jfull = await _allocate(kubelet, "tpu.sock", [f"tpu-accel{i}" for i in range(4)])
            tfull = await _allocate(kubelet, "nvidia-gpu.sock", [uuid(i) for i in range(4)])
            assert jfull.envs["TPU_WORKER_ID"] == tfull.envs["TPU_WORKER_ID"] == "3"
            assert len(tfull.devices) == 4 + len(controls)
            # a partial request carries no worker id in either
            tpart = await _allocate(kubelet, "nvidia-gpu.sock", [uuid(0)])
            assert "TPU_WORKER_ID" not in tpart.envs
    finally:
        await ref.stop()
        await port.stop()


async def test_allocate_unknown_device_rejected_as_reference(host):
    ref, port = plugins(host)
    await ref.serve()
    await port.serve()
    try:
        async with FakeKubelet(port.config.kubelet_dir) as kubelet:
            codes = []
            for endpoint, did in (("tpu.sock", "tpu-accel99"), ("nvidia-gpu.sock", "GPU-nope")):
                with pytest.raises(grpc.aio.AioRpcError) as ei:
                    await _allocate(kubelet, endpoint, [did])
                codes.append(ei.value.code())
            assert codes == [grpc.StatusCode.INVALID_ARGUMENT] * 2
    finally:
        await ref.stop()
        await port.stop()


async def test_cdi_default_matches_reference(host):
    ref, port = plugins(host, cdi_enabled=True, cdi_default=True,
                        cdi_dir=str(host / "cdi"))
    await ref.serve()
    await port.serve()
    spec_path = host / "cdi" / "nvidia.com-gpu.json"
    try:
        spec = json.loads(spec_path.read_text())
        assert spec["kind"] == "nvidia.com/gpu"
        assert [d["name"] for d in spec["devices"]] == sorted(uuid(i) for i in range(4))
        nodes = {d["name"]: d["containerEdits"]["deviceNodes"] for d in spec["devices"]}
        assert nodes[uuid(2)] == [{"path": "/dev/nvidia2", "hostPath": os.path.join(
            os.environ["TPU_HW_ROOT"], "dev", "nvidia2"), "permissions": "rw"}]
        assert [n["path"] for n in spec["containerEdits"]["deviceNodes"]] == [
            "/dev/nvidiactl", "/dev/nvidia-uvm"]
        async with FakeKubelet(port.config.kubelet_dir) as kubelet:
            jresp = await _allocate(kubelet, "tpu.sock", ["tpu-accel1", "tpu-accel2"])
            tresp = await _allocate(kubelet, "nvidia-gpu.sock", [uuid(1), uuid(2)])
            assert [d.name for d in jresp.cdi_devices] == [
                "google.com/tpu=accel1", "google.com/tpu=accel2"]
            assert [d.name for d in tresp.cdi_devices] == [
                f"nvidia.com/gpu={uuid(1)}", f"nvidia.com/gpu={uuid(2)}"]
            assert len(jresp.devices) == len(tresp.devices) == 0
            assert tresp.envs["CUDA_VISIBLE_DEVICES"] == f"{uuid(1)},{uuid(2)}"
    finally:
        await ref.stop()
        await port.stop()
    assert not spec_path.exists()  # shutdown removes the spec


@pytest.mark.parametrize("size, must", [(1, []), (2, []), (3, []), (2, [2]), (3, [0, 3]),
                                        (4, [1])])
async def test_preferred_allocation_sizes_match_reference(host, size, must):
    ref, port = plugins(host)
    await ref.serve()
    await port.serve()
    try:
        async with FakeKubelet(port.config.kubelet_dir) as kubelet:
            picks = []
            for endpoint, ids in (("tpu.sock", [f"tpu-accel{i}" for i in range(4)]),
                                  ("nvidia-gpu.sock", [uuid(i) for i in range(4)])):
                async with kubelet.plugin_channel(endpoint) as channel:
                    req = api_pb2.PreferredAllocationRequest()
                    req.container_requests.append(api_pb2.ContainerPreferredAllocationRequest(
                        available_deviceIDs=ids, must_include_deviceIDs=[ids[i] for i in must],
                        allocation_size=size))
                    resp = await rpc.DevicePluginStub(channel).GetPreferredAllocation(req)
                    picked = list(resp.container_responses[0].deviceIDs)
                    picks.append(picked)
                    assert picked[:len(must)] == [ids[i] for i in must]
                    assert set(picked) <= set(ids) and len(set(picked)) == len(picked)
            assert len(picks[0]) == len(picks[1]) == size
    finally:
        await ref.stop()
        await port.stop()


def test_preferred_allocation_keeps_cards_under_one_switch(host):
    plugin = GPUDevicePlugin(PluginConfig())
    plugin.refresh_devices()
    everything = [uuid(i) for i in range(4)]
    assert plugin.preferred_allocation(everything, [], 2) == [uuid(0), uuid(1)]
    assert plugin.preferred_allocation(everything, [uuid(2)], 2) == [uuid(2), uuid(3)]
    # cards 0 and 2 taken: 1 and 3 sit under two switches, so any pair ties
    # and the lowest indices win
    assert plugin.preferred_allocation([uuid(1), uuid(3)], [], 1) == [uuid(1)]
    # card 1 taken: the pair left under one switch beats the lowest indices
    assert plugin.preferred_allocation([uuid(0), uuid(2), uuid(3)], [], 2) == [uuid(2), uuid(3)]


def test_preferred_allocation_without_a_reported_topology(host, monkeypatch):
    """A driver that reports no PCIe ancestry (the card machine's): every
    pair counts as far, so the pick is the lowest NVML indices."""
    monkeypatch.setattr(nvml, "topology", lambda uuids: {})
    plugin = GPUDevicePlugin(PluginConfig())
    plugin.refresh_devices()
    assert plugin.preferred_allocation([uuid(3), uuid(1), uuid(2)], [], 2) == [uuid(1), uuid(2)]
    assert plugin.preferred_allocation([uuid(i) for i in range(4)], [uuid(3)], 2) == [
        uuid(3), uuid(0)]


async def test_chip_machine_layout_advertises_the_minor_node(tmp_path, monkeypatch):
    """The card machine's /dev held nvidia0 and nvidia2 for one card: the
    plugin keys the card on its UUID and maps NVML's minor, 2."""
    dev = tmp_path / "hw" / "dev"
    dev.mkdir(parents=True)
    for name in ("nvidia0", "nvidia2", "nvidiactl"):
        (dev / name).touch()
    monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path / "hw"))
    the_card = card(0, minor=2)
    monkeypatch.setattr(nvml, "inventory", lambda: inventory([the_card]))
    port = GPUDevicePlugin(PluginConfig(kubelet_dir=str(tmp_path / "kubelet")))
    await port.serve()
    try:
        async with FakeKubelet(port.config.kubelet_dir) as kubelet:
            async with kubelet.plugin_channel("nvidia-gpu.sock") as channel:
                stream = rpc.DevicePluginStub(channel).ListAndWatch(api_pb2.Empty())
                first = await asyncio.wait_for(stream.read(), timeout=5)
                assert [(d.ID, d.health) for d in first.devices] == [(the_card.uuid, "Healthy")]
            resp = await _allocate(kubelet, "nvidia-gpu.sock", [the_card.uuid])
            assert [(d.container_path, d.host_path) for d in resp.devices] == [
                ("/dev/nvidia2", str(dev / "nvidia2")), ("/dev/nvidiactl", str(dev / "nvidiactl"))]
    finally:
        await port.stop()


def test_lost_and_vanished_cards_stay_unhealthy(host, monkeypatch):
    plugin = GPUDevicePlugin(PluginConfig())
    assert plugin.refresh_devices()
    assert plugin.snapshot() == [(uuid(i), HEALTHY) for i in range(4)]
    # NVML answers "GPU is lost" for card 1 after its UUID: it keeps the
    # minor number it had and turns Unhealthy
    lost = [card(0), nvml.Card(1, uuid(1), -1, "", 0, lost=True), card(2), card(3)]
    monkeypatch.setattr(nvml, "inventory", lambda: inventory(lost))
    assert plugin.refresh_devices()
    assert plugin.health[uuid(1)] == UNHEALTHY and plugin.devices[uuid(1)] == (card(1),)
    # it drops out of NVML's list: still advertised, Unhealthy
    monkeypatch.setattr(nvml, "inventory", lambda: inventory([card(0), card(2), card(3)]))
    plugin.refresh_devices()
    assert len(plugin.snapshot()) == 4 and plugin.health[uuid(1)] == UNHEALTHY
    assert plugin.refresh_devices() is False  # no change, no update to send
    with pytest.raises(UnknownDevice):
        plugin.allocate(["GPU-nope"])


async def test_health_loop_marks_every_card_unhealthy_when_nvml_fails(host, monkeypatch):
    plugin = GPUDevicePlugin(PluginConfig(kubelet_dir=str(host / "kubelet"),
                                          health_interval=0.02))
    plugin.refresh_devices()

    def broken():
        raise nvml.NvmlError("libnvidia-ml.so.1: nvmlDeviceGetCount_v2 returned 9", 9)

    monkeypatch.setattr(nvml, "inventory", broken)
    queue = asyncio.Queue()
    plugin._watchers.add(queue)
    task = asyncio.create_task(plugin._health_loop())
    try:
        await asyncio.wait_for(queue.get(), timeout=5)
    finally:
        task.cancel()
    assert set(plugin.health.values()) == {UNHEALTHY} and len(plugin.health) == 4


@pytest.mark.parametrize("argv, strategy, mode", [
    ([], "none", "accel"), (["--slice-strategy", "single"], "single", "accel"),
    (["--slice-strategy", "mixed"], "mixed", "accel"), (["--mode", "vfio"], "none", "vfio"),
    (["--mode", "vfio", "--slice-strategy", "mixed"], "mixed", "vfio")])
def test_entry_point_parses_every_mode_and_strategy(argv, strategy, mode):
    got_strategy, config = plugin_main.parse_config(argv)
    assert (got_strategy, config.mode, config.resource_name) == (strategy, mode, "nvidia.com/gpu")
    assert config.socket_name == ("nvidia-gpu-vfio.sock" if mode == "vfio" else "nvidia-gpu.sock")
    assert not hasattr(sliceconfig, "StrategyNotPorted")
    for flat in ("none", "single"):
        (same,) = sliceconfig.build_plugin_configs(flat, config)
        assert same is config


async def _served(config, strategy, kubelet_dir):
    """Registrations made by run_plugins(strategy, config) within 10 s."""
    async with FakeKubelet(kubelet_dir) as kubelet:
        task = asyncio.create_task(sliceconfig.run_plugins(strategy, config, poll_seconds=0.05))
        try:
            await asyncio.wait_for(kubelet.registered.wait(), timeout=10)
            await asyncio.sleep(0.2)
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
    return [r.resource_name for r in kubelet.registrations]


async def test_entry_point_serves_mixed(host, monkeypatch):
    """``--slice-strategy mixed`` on a layout of two 1x2 partitions serves
    nvidia.com/gpu-1x2; on no layout, the flat resource."""
    run_tpu = host / "run_tpu"
    (run_tpu / "validations").mkdir(parents=True)
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(run_tpu))
    strategy, config = plugin_main.parse_config(["--slice-strategy", "mixed"])
    config.kubelet_dir, config.health_interval = str(host / "kubelet"), 0.05
    assert await _served(config, strategy, config.kubelet_dir) == ["nvidia.com/gpu"]
    (run_tpu / "slice_config.json").write_text(json.dumps({
        "profile": "halves", "topology": "2x2", "partitions": [
            {"shape": "1x2", "origin": [0, 0], "chip_ids": [0, 1], "hosts": [0]},
            {"shape": "1x2", "origin": [1, 0], "chip_ids": [2, 3], "hosts": [0]}]}))
    assert await _served(config, strategy, config.kubelet_dir) == ["nvidia.com/gpu-1x2"]


async def test_entry_point_serves_vfio(host, monkeypatch):
    """``--mode vfio`` serves the cards bound to vfio-pci, from sysfs."""
    make_vfio_host(host / "hw", 2)
    strategy, config = plugin_main.parse_config(["--mode", "vfio"])
    config.kubelet_dir, config.health_interval = str(host / "kubelet"), 0.05
    assert await _served(config, strategy, config.kubelet_dir) == ["nvidia.com/gpu"]
    plugin = GPUDevicePlugin(config)
    plugin.refresh_devices()
    assert plugin.snapshot() == [("0000:18:00.0", HEALTHY), ("0000:19:00.0", HEALTHY)]


def make_vfio_host(root, cards: int, switch: bool = True) -> None:
    """A host's sysfs with ``cards`` NVIDIA cards bound to vfio-pci, group
    i each, and an NVSwitch bridge; /dev/vfio holds the groups."""
    devices = root / "sys" / "bus" / "pci" / "devices"
    (root / "dev" / "vfio").mkdir(parents=True, exist_ok=True)
    (root / "dev" / "vfio" / "vfio").touch()
    functions = [(f"0000:{0x18 + i:02x}:00.0", "0x030200", str(i)) for i in range(cards)]
    if switch:
        functions.append(("0000:05:00.0", "0x068000", "40"))
    for addr, cls, group in functions:
        d = devices / addr
        d.mkdir(parents=True)
        (d / "vendor").write_text("0x10de\n")
        (d / "class").write_text(cls + "\n")
        os.symlink(f"../../../bus/pci/drivers/vfio-pci", d / "driver")
        os.symlink(f"../../../kernel/iommu_groups/{group}", d / "iommu_group")
        (root / "dev" / "vfio" / group).touch()


async def test_run_plugins_serves_and_registers(host):
    config = PluginConfig(kubelet_dir=str(host / "kubelet"), health_interval=0.05)
    async with FakeKubelet(config.kubelet_dir) as kubelet:
        task = asyncio.create_task(sliceconfig.run_plugins("single", config))
        try:
            await asyncio.wait_for(kubelet.registered.wait(), timeout=10)
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
    assert kubelet.registrations[0].resource_name == "nvidia.com/gpu"


async def test_run_plugins_without_nvml_fails(host, monkeypatch):
    def missing():
        raise nvml.NvmlError("NVML (libnvidia-ml.so.1) not found under '/' nor by the loader")

    monkeypatch.setattr(nvml, "inventory", missing)
    config = PluginConfig(kubelet_dir=str(host / "kubelet"))
    with pytest.raises(nvml.NvmlError, match=r"libnvidia-ml\.so\.1"):
        await asyncio.wait_for(sliceconfig.run_plugins("none", config), 10)
