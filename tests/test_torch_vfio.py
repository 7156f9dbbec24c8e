"""The port's vfio manager and vfio-mode device plugin against the
reference's on one synthetic sysfs tree, built twice: once with Google
functions (vendor 0x1ae0) for the reference, once with NVIDIA cards
(vendor 0x10de, class 0x0302) plus an NVSwitch bridge (class 0x0680) for
the port, beside a function of another vendor.  Compared: the bind writes
(``driver_override``, ``drivers_probe``), the group nodes under the root,
the vfio-mode device count, the decoy left untouched, and the mixed
strategy's units over the groups.  Differences on purpose: the port binds
by display class, the reference by vendor alone; the port's allocation
names the PCI addresses in KubeVirt's ``PCI_RESOURCE_<resource>`` env
where the reference puts chip indices in ``TPU_VISIBLE_CHIPS``; the
port's rooted bind also points the function's ``driver`` link at
``vfio-pci``, as the kernel would.  Exact equality: no tolerance."""

import json
import os

import pytest

from tpu_operator import hw as jhw
from tpu_operator.agents import vfio_manager as jvfio
from tpu_operator.deviceplugin import sliceconfig as jsliceconfig
from tpu_operator.deviceplugin.plugin import PluginConfig as JConfig
from tpu_operator.deviceplugin.plugin import TPUDevicePlugin
from tpu_operator_torch import hw
from tpu_operator_torch.agents import vfio_manager
from tpu_operator_torch.deviceplugin import sliceconfig
from tpu_operator_torch.deviceplugin.plugin import HEALTHY, GPUDevicePlugin, PluginConfig
from tpu_operator_torch.validator import components

CARDS = [f"0000:{0x18 + i:02x}:00.0" for i in range(4)]
SWITCH = "0000:05:00.0"
OTHER = "0000:00:03.0"


def make_tree(root, vendor: str, card_class: str, switch: bool) -> None:
    """Four accelerator functions (IOMMU groups 0-3, bound to the
    accelerator's driver), another vendor's function and, for the port, an
    NVSwitch of the accelerator's vendor (group 40)."""
    devices = root / "sys" / "bus" / "pci" / "devices"
    functions = [(a, vendor, card_class, str(i)) for i, a in enumerate(CARDS)]
    functions.append((OTHER, "0x8086", "0x020000", "9"))
    if switch:
        functions.append((SWITCH, vendor, "0x068000", "40"))
    for addr, ven, cls, group in functions:
        d = devices / addr
        d.mkdir(parents=True)
        (d / "vendor").write_text(ven + "\n")
        (d / "class").write_text(cls + "\n")
        os.symlink("../../../bus/pci/drivers/accel", d / "driver")
        os.symlink(f"../../../kernel/iommu_groups/{group}", d / "iommu_group")
    (root / "sys" / "bus" / "pci" / "drivers_probe").touch()
    (root / "dev" / "vfio").mkdir(parents=True)
    (root / "dev" / "vfio" / "vfio").touch()


def bind_all(module, find, root, monkeypatch):
    """Run the manager's scan and bind under ``root``; returns what it
    wrote and made."""
    monkeypatch.setenv("TPU_HW_ROOT", str(root))
    devices = root / "sys" / "bus" / "pci" / "devices"
    addrs = find()
    probes = []
    for a in addrs:
        assert module.bind_to_vfio(a)
        probes.append((root / "sys" / "bus" / "pci" / "drivers_probe").read_text())
    overrides = {a: (devices / a / "driver_override").read_text()
                 for a in sorted(os.listdir(devices)) if (devices / a / "driver_override").exists()}
    groups = sorted(os.listdir(root / "dev" / "vfio"))
    return addrs, probes, overrides, groups


@pytest.fixture
def trees(tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    make_tree(ref, "0x1ae0", "0x120000", switch=False)
    make_tree(port, "0x10de", "0x030200", switch=True)
    return ref, port


def test_vfio_manager_binds_as_the_reference(trees, monkeypatch):
    ref_root, port_root = trees
    ref = bind_all(jvfio, jvfio.tpu_pci_addresses, ref_root, monkeypatch)
    jcount = len(jhw.vfio_device_paths())
    mine = bind_all(vfio_manager, vfio_manager.gpu_pci_addresses, port_root, monkeypatch)
    assert mine == ref
    addrs, probes, overrides, groups = mine
    assert addrs == probes == CARDS
    assert overrides == dict.fromkeys(CARDS, "vfio-pci")  # the NVSwitch is not bound
    assert groups == ["0", "1", "2", "3", "vfio"]
    assert len(hw.vfio_device_paths()) == jcount == 4
    # the rooted bind points the cards' driver links at vfio-pci; the
    # decoys keep theirs
    devices = port_root / "sys" / "bus" / "pci" / "devices"
    assert [os.path.basename(os.readlink(devices / a / "driver")) for a in CARDS] == [
        "vfio-pci"] * 4
    for decoy in (SWITCH, OTHER):
        assert os.path.basename(os.readlink(devices / decoy / "driver")) == "accel"
    assert [f.address for f in hw.vfio_cards()] == CARDS
    # a second pass writes nothing and makes no group
    (devices / CARDS[0] / "driver_override").write_text("")
    assert vfio_manager.bind_to_vfio(CARDS[0])
    assert (devices / CARDS[0] / "driver_override").read_text() == ""
    assert sorted(os.listdir(port_root / "dev" / "vfio")) == groups


def test_the_nvswitch_rule():
    assert hw.is_card_function(0x10DE, 0x030200) and hw.is_card_function(0x10DE, 0x030000)
    assert not hw.is_card_function(0x10DE, 0x068000)  # NVSwitch, a bridge
    assert not hw.is_card_function(0x10DE, 0x040300)  # the card's audio function
    assert not hw.is_card_function(0x1AE0, 0x030200)


def test_vfio_mode_advertises_the_groups_as_the_reference(trees, monkeypatch):
    ref_root, port_root = trees
    monkeypatch.setenv("TPU_HW_ROOT", str(ref_root))
    for a in jvfio.tpu_pci_addresses():
        jvfio.bind_to_vfio(a)
    ref = TPUDevicePlugin(JConfig(mode="vfio"))
    ref.refresh_devices()
    monkeypatch.setenv("TPU_HW_ROOT", str(port_root))
    for a in vfio_manager.gpu_pci_addresses():
        vfio_manager.bind_to_vfio(a)
    port = GPUDevicePlugin(PluginConfig(mode="vfio"))
    port.refresh_devices()
    assert len(port.devices) == len(ref.devices) == 4
    assert port.snapshot() == [(a, HEALTHY) for a in CARDS]
    alloc = port.allocate([CARDS[2], CARDS[1]])
    group = str(port_root / "dev" / "vfio")
    assert alloc["envs"] == {"PCI_RESOURCE_NVIDIA_COM_GPU": f"{CARDS[1]},{CARDS[2]}"}
    assert alloc["devices"] == [("/dev/vfio/1", f"{group}/1", "rw"),
                                ("/dev/vfio/2", f"{group}/2", "rw"),
                                ("/dev/vfio/vfio", f"{group}/vfio", "rw")]
    # a group node gone: that card turns Unhealthy, still advertised
    os.remove(os.path.join(group, "3"))
    assert port.refresh_devices()
    assert port.health[CARDS[3]] == "Unhealthy" and len(port.devices) == 4


def test_mixed_vfio_serves_partitioned_passthrough(trees, monkeypatch):
    """The reference's test on a 2x4 slice of eight passthrough chips,
    groups 7-14: each unit holds exactly its partition's groups."""
    _, root = trees
    devices = root / "sys" / "bus" / "pci" / "devices"
    for i in range(4, 8):
        d = devices / f"0000:{0x18 + i:02x}:00.0"
        d.mkdir()
        (d / "vendor").write_text("0x10de\n")
        (d / "class").write_text("0x030200\n")
        os.symlink("../../../bus/pci/drivers/accel", d / "driver")
    for i, d in enumerate(sorted(p for p in devices.iterdir() if p.name >= "0000:18")):
        os.remove(d / "driver")
        os.symlink("../../../bus/pci/drivers/vfio-pci", d / "driver")
        if (d / "iommu_group").is_symlink():
            os.remove(d / "iommu_group")
        os.symlink(f"../../../kernel/iommu_groups/{7 + i}", d / "iommu_group")
        (root / "dev" / "vfio" / str(7 + i)).touch()
    monkeypatch.setenv("TPU_HW_ROOT", str(root))
    run_tpu = root / "run" / "tpu"
    (run_tpu / "validations").mkdir(parents=True)
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(run_tpu))
    monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    (run_tpu / "slice_config.json").write_text(json.dumps({
        "config": "all-balanced", "topology": "2x4", "partitions": [
            {"shape": "2x2", "chip_ids": [0, 1, 4, 5]},
            {"shape": "2x2", "chip_ids": [2, 3, 6, 7]}]}))
    jgroups = jsliceconfig.build_plugin_configs("mixed", JConfig(mode="vfio"))
    (config,) = sliceconfig.build_plugin_configs("mixed", PluginConfig(mode="vfio"))
    assert (config.resource_name, config.mode, config.socket_name) == (
        "nvidia.com/gpu-2x2", "vfio", "nvidia-gpu-2x2-vfio.sock")
    assert config.device_sets == {"gpu-2x2-0": [0, 1, 4, 5], "gpu-2x2-1": [2, 3, 6, 7]}
    port = GPUDevicePlugin(config)
    port.refresh_devices()
    groups = {did: sorted(hw.vfio_group_path(m.iommu_group) for m in members)
              for did, members in port.devices.items()}
    ref = {did.replace("tpu-", "gpu-"): sorted(paths)
           for did, paths in jgroups[0].device_sets.items()}
    assert groups == ref
    assert set(port.health.values()) == {HEALTHY}
    alloc = port.allocate(["gpu-2x2-1"])
    assert alloc["envs"] == {"PCI_RESOURCE_NVIDIA_COM_GPU-2X2": ",".join(
        f"0000:{0x18 + i:02x}:00.0" for i in (2, 3, 6, 7))}
    assert [d[0] for d in alloc["devices"]] == [f"/dev/vfio/{7 + i}" for i in (2, 3, 6, 7)] + [
        "/dev/vfio/vfio"]


async def test_vfio_pci_component_passes_on_the_bound_tree(trees, monkeypatch, tmp_path):
    """The port's ``validator.cli --component vfio-pci`` reads the group
    nodes the manager made, as the reference's does."""
    _, root = trees
    monkeypatch.setenv("TPU_HW_ROOT", str(root))
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(tmp_path / "v"))
    for a in vfio_manager.gpu_pci_addresses():
        vfio_manager.bind_to_vfio(a)
    v = components.Validator(components.ValidatorConfig(node_name="", sleep_interval=0.01))
    await v.run("vfio-pci")
    payload = json.loads((tmp_path / "v" / "validations" / "vfio-pci-ready").read_text())
    assert payload["devices"] == [str(root / "dev" / "vfio" / g) for g in "0123"]
