"""The port's mixed slice strategy (``deviceplugin/sliceconfig.py`` and the
plugin's partition units) against the reference's on one synthetic host:
the reference sees ``/dev/accel0..3``, the port ``/dev/nvidia0..3`` and a
four-card NVML inventory put in place of the library's.  Compared: the
units a host owns, the plugin set each strategy builds, a unit's
allocation over gRPC and the refusal of two units, a unit's health when
one of its cards is lost, and the incremental reconcile.  Differences on
purpose: the port's resources are ``nvidia.com/gpu-<shape>`` and its units
``gpu-<shape>-<k>`` of NVML indices (the reference's ``tpu-<shape>-<k>``
of ``/dev/accel`` paths); its allocation names the unit's UUIDs in NVML's
order where the reference names chip indices and ICI bounds.  Exact
equality: no tolerance."""

import asyncio
import json
import os

import grpc
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_deviceplugin import card, host, inventory, uuid  # noqa: F401
from tpu_operator.deviceplugin import api_pb2, rpc
from tpu_operator.deviceplugin import sliceconfig as jsliceconfig
from tpu_operator.deviceplugin.plugin import PluginConfig as JConfig
from tpu_operator.deviceplugin.plugin import TPUDevicePlugin, chip_index
from tpu_operator.testing.fakekubelet import FakeKubelet
from tpu_operator_torch import nvml
from tpu_operator_torch.deviceplugin import sliceconfig
from tpu_operator_torch.deviceplugin.plugin import (HEALTHY, UNHEALTHY, AllocationRefused,
                                                   GPUDevicePlugin, PluginConfig)

partitions = st.lists(st.fixed_dictionaries({
    "shape": st.sampled_from(["1x1", "1x2", "2x2", "2x4"]),
    "chip_ids": st.lists(st.integers(0, 15), unique=True, max_size=8)}), max_size=6)


@settings(max_examples=100, deadline=None)
@given(partitions, st.integers(0, 3), st.integers(1, 8))
def test_host_units_match_reference(parts, worker, per_host):
    layout = {"topology": "4x4", "partitions": parts}
    assert sliceconfig.host_units(layout, worker, per_host) == jsliceconfig.host_units(
        layout, worker, per_host)
    assert sliceconfig.host_units(None, worker, per_host) == {}


@pytest.fixture
def run_tpu(host, monkeypatch):
    root = host / "run_tpu"
    (root / "validations").mkdir(parents=True)
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(root))
    monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    return root


def write_layout(run_tpu, topology, parts):
    (run_tpu / "slice_config.json").write_text(json.dumps({
        "profile": "p", "topology": topology,
        "partitions": [{"shape": shape, "chip_ids": ids} for shape, ids in parts]}))


def plugin_set(configs, prefix, unit_prefix):
    """[(shape suffix, device_shape, {k: local indices})] of a plugin set."""
    out = []
    for c in configs:
        assert c.resource_name.startswith(prefix)
        units = None
        if c.device_sets is not None:
            units = {}
            for did, members in c.device_sets.items():
                assert did.startswith(unit_prefix)
                units[did.rsplit("-", 1)[1]] = [
                    m if isinstance(m, int) else chip_index(os.path.basename(m))
                    for m in members]
        out.append((c.resource_name[len(prefix):], c.device_shape, units))
    return out


@pytest.mark.parametrize("strategy, topology, parts, worker, expect", [
    ("none", "2x2", [("1x2", [0, 1]), ("1x2", [2, 3])], None, [("", "", None)]),
    ("single", "2x2", [("1x2", [0, 1]), ("1x2", [2, 3])], None, [("", "", None)]),
    ("mixed", "2x2", [("1x2", [0, 1]), ("1x2", [2, 3])], None,
     [("-1x2", "1x2", {"0": [0, 1], "1": [2, 3]})]),
    ("mixed", "2x2", [("1x2", [0, 1]), ("1x1", [2]), ("1x1", [3])], None,
     [("-1x1", "1x1", {"0": [2], "1": [3]}), ("-1x2", "1x2", {"0": [0, 1]})]),
    ("mixed", "2x4", [("1x4", [0, 1, 2, 3]), ("1x4", [4, 5, 6, 7])], None, [("", "", None)]),
    ("mixed", "2x4", [("1x4", [0, 1, 2, 3]), ("1x4", [4, 5, 6, 7])], "1",
     [("-1x4", "1x4", {"0": [0, 1, 2, 3]})]),
    ("mixed", "2x4", [("2x2", [0, 1, 4, 5]), ("2x2", [2, 3, 6, 7])], "0",
     [("-2x2", "2x2", {"0": [0, 1], "1": [2, 3]})]),
    ("mixed", "2x2", [], None, [("", "", None)]),
    ("mixed", None, None, None, [("", "", None)]),
])
def test_build_plugin_configs_match_reference(run_tpu, monkeypatch, strategy, topology, parts,
                                              worker, expect):
    if topology is not None:
        write_layout(run_tpu, topology, parts)
    if worker is not None:
        monkeypatch.setenv("TPU_WORKER_ID", worker)
    ref = plugin_set(jsliceconfig.build_plugin_configs(strategy, JConfig()), "google.com/tpu",
                     "tpu-")
    mine_configs = sliceconfig.build_plugin_configs(strategy, PluginConfig())
    mine = plugin_set(mine_configs, "nvidia.com/gpu", "gpu-")
    assert mine == ref == expect
    for c in mine_configs:
        assert c.socket_name == ("nvidia-gpu.sock" if c.device_sets is None
                                 else f"nvidia-gpu-{c.device_shape}.sock")


def unit_plugins(host, run_tpu, parts=(("1x2", [0, 1]), ("1x2", [2, 3]))):
    """The reference's and the port's plugin for the 1x2 units."""
    write_layout(run_tpu, "2x2", parts)
    kubelet_dir = str(host / "kubelet")
    (jcfg,) = jsliceconfig.build_plugin_configs("mixed", JConfig(kubelet_dir=kubelet_dir))
    (tcfg,) = sliceconfig.build_plugin_configs("mixed", PluginConfig(kubelet_dir=kubelet_dir))
    return TPUDevicePlugin(jcfg), GPUDevicePlugin(tcfg)


async def _allocate(kubelet, endpoint, ids):
    async with kubelet.plugin_channel(endpoint) as channel:
        req = api_pb2.AllocateRequest()
        req.container_requests.append(api_pb2.ContainerAllocateRequest(devicesIDs=ids))
        return (await rpc.DevicePluginStub(channel).Allocate(req)).container_responses[0]


async def test_unit_allocate_matches_reference(host, run_tpu, monkeypatch):
    """A unit's allocation names its UUIDs in NVML's order (here the minor
    numbers run the other way) and maps their nodes and the control nodes;
    neither package sets a worker id for a unit, even a whole-host one;
    both refuse two units in one container."""
    cards = [card(i, minor=3 - i) for i in range(4)]
    monkeypatch.setattr(nvml, "inventory", lambda: inventory(cards))
    (run_tpu / "worker_id").write_text("0")
    ref, port = unit_plugins(host, run_tpu)
    await ref.serve()
    await port.serve()
    root = os.environ["TPU_HW_ROOT"]
    try:
        async with FakeKubelet(port.config.kubelet_dir) as kubelet:
            assert [(d, h) for d, h in port.snapshot()] == [("gpu-1x2-0", HEALTHY),
                                                            ("gpu-1x2-1", HEALTHY)]
            jresp = await _allocate(kubelet, "tpu-1x2.sock", ["tpu-1x2-1"])
            tresp = await _allocate(kubelet, "nvidia-gpu-1x2.sock", ["gpu-1x2-1"])
            assert jresp.envs["TPU_VISIBLE_CHIPS"] == "2,3"
            visible = f"{uuid(2)},{uuid(3)}"
            assert dict(tresp.envs) == {"CUDA_VISIBLE_DEVICES": visible,
                                        "NVIDIA_VISIBLE_DEVICES": visible}
            assert "TPU_WORKER_ID" not in jresp.envs
            assert [(d.container_path, d.host_path) for d in tresp.devices] == [
                ("/dev/nvidia1", os.path.join(root, "dev", "nvidia1")),
                ("/dev/nvidia0", os.path.join(root, "dev", "nvidia0")),
                ("/dev/nvidiactl", os.path.join(root, "dev", "nvidiactl")),
                ("/dev/nvidia-uvm", os.path.join(root, "dev", "nvidia-uvm"))]
            codes = []
            for endpoint, ids in (("tpu-1x2.sock", ["tpu-1x2-0", "tpu-1x2-1"]),
                                  ("nvidia-gpu-1x2.sock", ["gpu-1x2-0", "gpu-1x2-1"])):
                with pytest.raises(grpc.aio.AioRpcError) as ei:
                    await _allocate(kubelet, endpoint, ids)
                codes.append((ei.value.code(), "at most one partition unit" in
                              ei.value.details()))
            assert codes == [(grpc.StatusCode.INVALID_ARGUMENT, True)] * 2
    finally:
        await ref.stop()
        await port.stop()


def test_unit_with_a_lost_card_is_unhealthy(host, run_tpu, monkeypatch):
    """One lost card makes its whole unit Unhealthy, in both; the unit is
    never dropped nor served with fewer cards."""
    ref, port = unit_plugins(host, run_tpu)
    ref.refresh_devices()
    port.refresh_devices()
    assert sorted(ref.health.values()) == sorted(port.health.values()) == [HEALTHY] * 2
    os.remove(os.path.join(os.environ["TPU_HW_ROOT"], "dev", "accel1"))
    lost = [card(0), nvml.Card(1, uuid(1), -1, "", 0, lost=True), card(2), card(3)]
    monkeypatch.setattr(nvml, "inventory", lambda: inventory(lost))
    assert ref.refresh_devices() and port.refresh_devices()
    assert ref.health == {"tpu-1x2-0": UNHEALTHY, "tpu-1x2-1": HEALTHY}
    assert port.health == {"gpu-1x2-0": UNHEALTHY, "gpu-1x2-1": HEALTHY}
    assert port.devices["gpu-1x2-0"] == (card(0), card(1))  # keeps the minor it had
    # the card drops out of NVML's list: the unit stays, whole, Unhealthy
    monkeypatch.setattr(nvml, "inventory", lambda: inventory([card(0), card(2), card(3)]))
    port.refresh_devices()
    assert port.health == {"gpu-1x2-0": UNHEALTHY, "gpu-1x2-1": HEALTHY}
    assert port.allocate(["gpu-1x2-0"])["envs"]["CUDA_VISIBLE_DEVICES"] == (
        f"{uuid(0)},{uuid(1)}")
    # its node gone too: Unhealthy until both are back
    os.remove(os.path.join(os.environ["TPU_HW_ROOT"], "dev", "nvidia1"))
    monkeypatch.setattr(nvml, "inventory", lambda: inventory([card(i) for i in range(4)]))
    port.refresh_devices()
    assert port.health["gpu-1x2-0"] == UNHEALTHY
    (host / "hw" / "dev" / "nvidia1").touch()
    assert port.refresh_devices() and port.health["gpu-1x2-0"] == HEALTHY


def test_unit_of_a_card_never_listed(host, run_tpu, monkeypatch):
    """A unit whose card NVML has never listed is Unhealthy and refuses an
    allocation rather than serving the cards it has.  NVML counts four
    cards and lists three (card 1 lost before its UUID)."""
    three = nvml.Inventory((card(0), card(2), card(3)), "570.124.06", "12.8", 4)
    monkeypatch.setattr(nvml, "inventory", lambda: three)
    _, port = unit_plugins(host, run_tpu)
    port.refresh_devices()
    assert port.health == {"gpu-1x2-0": UNHEALTHY, "gpu-1x2-1": HEALTHY}
    with pytest.raises(AllocationRefused, match="never listed"):
        port.allocate(["gpu-1x2-0"])
    monkeypatch.setattr(nvml, "inventory", lambda: inventory([card(i) for i in range(4)]))
    port.refresh_devices()
    assert port.health["gpu-1x2-0"] == HEALTHY


def test_unit_preferred_allocation_is_the_contiguous_window(host, run_tpu):
    parts = [("1x1", [i]) for i in range(4)]
    ref, port = unit_plugins(host, run_tpu, parts)
    ref.refresh_devices()
    port.refresh_devices()
    for available, must, size in (([0, 1, 2, 3], [], 2), ([0, 2, 3], [], 2),
                                  ([1, 3, 0], [3], 2), ([0, 1, 2, 3], [], 4)):
        picks = [plugin.preferred_allocation([f"{p}-1x1-{i}" for i in available],
                                             [f"{p}-1x1-{i}" for i in must], size)
                 for p, plugin in (("tpu", ref), ("gpu", port))]
        assert [[chip_index(d) for d in pick] for pick in picks][0] == [
            chip_index(d) for d in picks[1]]


async def test_run_plugins_keeps_an_unchanged_shape(host, run_tpu):
    """A repartition that touches only the 1x1 shape re-registers only the
    1x1 plugin, in both."""
    def layout(ones):
        write_layout(run_tpu, "2x2", [("1x2", [0, 1])] + [("1x1", [c]) for c in ones])

    async def registrations(module, config_cls, prefix, kubelet_dir):
        layout([2, 3])

        def count(kubelet, resource):
            return sum(r.resource_name == resource for r in kubelet.registrations)

        base = config_cls(kubelet_dir=kubelet_dir, health_interval=0.05)
        async with FakeKubelet(kubelet_dir) as kubelet:
            task = asyncio.create_task(module.run_plugins("mixed", base, poll_seconds=0.05))
            try:
                for _ in range(200):
                    if count(kubelet, f"{prefix}-1x2") and count(kubelet, f"{prefix}-1x1"):
                        break
                    await asyncio.sleep(0.05)
                first = (count(kubelet, f"{prefix}-1x2"), count(kubelet, f"{prefix}-1x1"))
                layout([2])
                for _ in range(200):
                    if count(kubelet, f"{prefix}-1x1") >= 2:
                        break
                    await asyncio.sleep(0.05)
                return first, (count(kubelet, f"{prefix}-1x2"), count(kubelet, f"{prefix}-1x1"))
            finally:
                task.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await task

    ref = await registrations(jsliceconfig, JConfig, "google.com/tpu", str(host / "k-ref"))
    mine = await registrations(sliceconfig, PluginConfig, "nvidia.com/gpu", str(host / "k-port"))
    assert mine == ref == ((1, 1), (1, 2))


async def test_mixed_without_nvml_fails(host, run_tpu, monkeypatch):
    """``mixed`` on a node where NVML fails ends the plugin with the NVML
    error, as ``none`` does."""
    write_layout(run_tpu, "2x2", [("1x2", [0, 1]), ("1x2", [2, 3])])

    def missing():
        raise nvml.NvmlError("NVML (libnvidia-ml.so.1) not found under '/' nor by the loader")

    monkeypatch.setattr(nvml, "inventory", missing)
    config = PluginConfig(kubelet_dir=str(host / "kubelet"))
    with pytest.raises(nvml.NvmlError, match=r"libnvidia-ml\.so\.1"):
        await asyncio.wait_for(sliceconfig.run_plugins("mixed", config), 10)
