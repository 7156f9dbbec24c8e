"""The port's operand agents against the reference's on the same trees and
fake clusters: the runtime manager's upgrade handover, the config
manager's pick, runtime prep, the runtime container's marker and the VM
runtime manager's drop-ins.  Differences on purpose, each asserted where
it shows: the port evicts pods asking for ``nvidia.com/gpu`` (the
reference ``google.com/tpu``); runtime prep sets the permissions of the
cards' nodes NVML names and of the driver's control nodes (the reference
of ``/dev/accel*``); the installer stamps ``<driver>-cuda<CUDA>`` from NVML
(the reference the env's channel), counts the live cards NVML lists and
places its payload where GKE's driver installer puts the driver's
libraries.  The drop-ins are byte-identical.  Exact equality: no
tolerance."""

import asyncio
import os

import pytest

from tests.test_torch_deviceplugin import card, inventory
from tpu_operator import consts as jconsts
from tpu_operator.agents import config_manager as jconfig_manager
from tpu_operator.agents import libtpu_installer as jinstaller
from tpu_operator.agents import runtime_manager as jruntime_manager
from tpu_operator.agents import runtime_prep as jprep
from tpu_operator.agents import vm_runtime_manager as jvrm
from tpu_operator.k8s.client import ApiClient as JClient
from tpu_operator.k8s.client import ApiError as JApiError
from tpu_operator.k8s.client import Config as JClientConfig
from tpu_operator.testing import FakeCluster, SimConfig
from tpu_operator_torch import consts, nvml
from tpu_operator_torch.agents import config_manager, libtpu_installer, runtime_manager
from tpu_operator_torch.agents import runtime_prep, vm_runtime_manager
from tpu_operator_torch.k8s.client import ApiClient, ApiError, Config
from tpu_operator_torch.validator import components

NS = "tpu-operator"


@pytest.fixture
def host(tmp_path, monkeypatch):
    """One synthetic host for both packages: four accel nodes, four card
    nodes, two control nodes, two vfio groups and the driver's library; a
    four-card NVML inventory."""
    dev = tmp_path / "hw" / "dev"
    (dev / "vfio").mkdir(parents=True)
    for i in range(4):
        (dev / f"accel{i}").touch()
        (dev / f"nvidia{i}").touch()
    for name in ("nvidiactl", "nvidia-uvm", "vfio/0", "vfio/1", "vfio/vfio"):
        (dev / name).touch()
    lib = tmp_path / "hw" / "usr" / "lib" / "x86_64-linux-gnu"
    lib.mkdir(parents=True)
    (lib / "libcuda.so.1").touch()
    monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path / "hw"))
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(tmp_path / "run"))
    monkeypatch.delenv("LIBCUDA_PATH", raising=False)
    monkeypatch.setattr(nvml, "inventory", lambda: inventory([card(i) for i in range(4)]))
    return tmp_path / "hw"


# ---------------------------------------------------------------------------
# the runtime manager


def _pod(name, resource=None, daemonset=False, node="node-0"):
    meta = {"name": name, "namespace": "default"}
    if daemonset:
        meta["ownerReferences"] = [{"apiVersion": "apps/v1", "kind": "DaemonSet",
                                    "name": "operand", "uid": "ds"}]
    limits = {resource: "1"} if resource else {}
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": {
        "nodeName": node, "containers": [{"name": "c", "resources": {"limits": limits}}]}}


async def _handover(module, client_cls, config_cls, resource, annotation, force, monkeypatch):
    """Run ``module.run()`` on a node with the upgrade annotation set (or
    not); returns (rc, the pods left, the node's annotations)."""
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        node = fc.add_node("node-0")
        if annotation:
            node["metadata"]["annotations"][jconsts.UPGRADE_REQUESTED_ANNOTATION] = annotation
        fc.put(node)
        for pod in (_pod("train", resource), _pod("unit", resource + "-1x2"),
                    _pod("operand", resource, daemonset=True), _pod("web"),
                    _pod("elsewhere", resource, node="node-1")):
            fc.put(pod)
        monkeypatch.setenv("NODE_NAME", "node-0")
        monkeypatch.setenv("KUBERNETES_API_URL", fc.base_url)
        monkeypatch.setenv("DRAIN_TIMEOUT_SECONDS", "2")
        monkeypatch.setenv("DRAIN_USE_FORCE", "true" if force else "false")
        rc = await module.run()
        async with client_cls(config_cls(base_url=fc.base_url)) as client:
            pods = sorted(p["metadata"]["name"] for p in await client.list_items("", "Pod"))
            node = await client.get("", "Node", "node-0")
        return rc, pods, node["metadata"].get("annotations") or {}


@pytest.mark.parametrize("annotation, force", [("true", False), ("true", True), ("1", False),
                                               (None, False), ("false", True)])
async def test_runtime_manager_matches_reference(monkeypatch, annotation, force):
    ref = await _handover(jruntime_manager, JClient, JClientConfig, "google.com/tpu",
                          annotation, force, monkeypatch)
    mine = await _handover(runtime_manager, ApiClient, Config, "nvidia.com/gpu", annotation,
                           force, monkeypatch)
    assert mine == ref
    rc, pods, annotations = mine
    assert rc == 0
    if annotation in ("true", "1"):
        assert consts.UPGRADE_REQUESTED_ANNOTATION not in annotations
        assert pods == (["elsewhere", "web"] if force else ["elsewhere", "operand", "web"])
    else:
        assert pods == ["elsewhere", "operand", "train", "unit", "web"]


def test_pod_filter_matches_reference():
    for resource, expect in (("", False), ("nvidia.com/gpu", True),
                             ("nvidia.com/gpu-2x2", True), ("amd.com/gpu", False)):
        pod = _pod("p", resource or None)
        ref_pod = _pod("p", resource.replace("nvidia.com/gpu", "google.com/tpu") or None)
        assert runtime_manager.pod_requests_gpu(pod) == jruntime_manager.pod_requests_tpu(
            ref_pod) == expect


# ---------------------------------------------------------------------------
# the config manager


async def test_config_manager_matches_reference(tmp_path):
    async with FakeCluster(SimConfig(enabled=False)) as fc:
        node = fc.add_node("node-0", labels={jconfig_manager.NODE_CONFIG_LABEL: "perf"})
        fc.put({"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": "plugin-config", "namespace": NS},
                "data": {"default": "mode: default\n", "perf.yaml": "mode: perf\n"}})
        assert config_manager.NODE_CONFIG_LABEL == jconfig_manager.NODE_CONFIG_LABEL
        async with JClient(JClientConfig(base_url=fc.base_url)) as jclient, \
                ApiClient(Config(base_url=fc.base_url)) as client:
            async def both(label):
                if label is None:
                    node["metadata"]["labels"].pop(jconfig_manager.NODE_CONFIG_LABEL, None)
                else:
                    node["metadata"]["labels"][jconfig_manager.NODE_CONFIG_LABEL] = label
                fc.put(node)
                out = []
                for module, c, name in ((jconfig_manager, jclient, "ref"),
                                        (config_manager, client, "port")):
                    target = tmp_path / name / "config.yaml"
                    try:
                        selected = await module.sync_once(c, "node-0", "plugin-config", NS,
                                                          "default", str(target))
                    except (ApiError, JApiError) as e:
                        selected = (e.status, str(e.body))
                    out.append((selected, target.read_text() if target.exists() else None,
                                target.stat().st_mtime_ns if target.exists() else None))
                return out

            ref, mine = await both("perf")
            assert ref[:2] == mine[:2] == ("perf", "mode: perf\n")
            ref2, mine2 = await both("perf")  # unchanged content: no rewrite
            assert mine2 == mine and ref2 == ref
            ref, mine = await both(None)
            assert ref[:2] == mine[:2] == ("default", "mode: default\n")
            ref, mine = await both("absent")
            assert ref[0] == mine[0] == (404, "config 'absent' not in ConfigMap plugin-config")
            assert mine[1] == "mode: default\n"  # left as it was


# ---------------------------------------------------------------------------
# runtime prep


async def _serve_briefly(run):
    """Start an agent's ``run()``, let it write, stop it; returns nothing
    (the caller inspects the files)."""
    task = asyncio.create_task(run())
    await asyncio.sleep(0.1)
    return task


async def test_runtime_prep_matches_reference(host, monkeypatch):
    monkeypatch.setenv("DEVICE_PERMISSIONS", "0660")
    monkeypatch.setenv("HUGEPAGES_GB", "8")
    dev = str(host / "dev")
    ref = jprep.prep()
    hugepages = (host / "sys/kernel/mm/hugepages/hugepages-1048576kB/nr_hugepages").read_text()
    for p in ref["devices"]:
        os.chmod(p, 0o600)
    mine = runtime_prep.prep()
    assert mine["permissions"] == ref["permissions"] == "0o660"
    assert ref["devices"] == [f"{dev}/accel{i}" for i in range(4)] + [f"{dev}/vfio/0",
                                                                      f"{dev}/vfio/1"]
    assert mine["devices"] == [f"{dev}/nvidia{i}" for i in range(4)] + [
        f"{dev}/nvidiactl", f"{dev}/nvidia-uvm", f"{dev}/vfio/0", f"{dev}/vfio/1"]
    assert all(os.stat(p).st_mode & 0o777 == 0o660 for p in mine["devices"])
    assert (host / "sys/kernel/mm/hugepages/hugepages-1048576kB/nr_hugepages").read_text() \
        == hugepages == "8"
    # the cards' nodes by NVML's minors: a stale node is left alone
    (host / "dev" / "nvidia7").touch()
    assert f"{dev}/nvidia7" not in runtime_prep.prep()["devices"]
    # no NVML (a passthrough host): the vfio groups and control nodes only
    monkeypatch.setattr(nvml, "inventory", lambda: (_ for _ in ()).throw(nvml.NvmlError("x")))
    assert runtime_prep.prep()["devices"] == [f"{dev}/nvidiactl", f"{dev}/nvidia-uvm",
                                              f"{dev}/vfio/0", f"{dev}/vfio/1"]


@pytest.mark.parametrize("module, component", [(jprep, "runtime-prep"),
                                               (runtime_prep, "runtime-prep")])
async def test_runtime_prep_ready_file(host, module, component):
    from tpu_operator_torch.validator import status

    task = await _serve_briefly(module.run)
    assert status.read_status(component)["permissions"] == "0o666"
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    assert not status.is_ready(component)  # cleared on shutdown


# ---------------------------------------------------------------------------
# the runtime container's marker


def test_installer_matches_reference(host, tmp_path, monkeypatch):
    src = tmp_path / "payload" / "libcuda.so.570.124.06"
    src.parent.mkdir()
    src.write_bytes(b"\x7fELF-fake-library")
    monkeypatch.setenv("LIBTPU_SRC", str(src))
    monkeypatch.setenv("LIBTPU_VERSION", "libtpu-2026-02-01")
    ref = jinstaller.install()
    mine = libtpu_installer.install()
    assert (ref["installed"], ref["chips"]) == (mine["installed"], mine["chips"]) == (True, 4)
    assert ref["version"] == "libtpu-2026-02-01"
    assert mine["version"] == "570.124.06-cuda12.8"  # the runtime.version label's text
    target = host / "home" / "kubernetes" / "bin" / "nvidia" / "lib64" / src.name
    assert mine["target"] == str(target) and target.read_bytes() == src.read_bytes()
    assert (target.parent / "version").read_text() == mine["version"]
    assert jinstaller.install()["installed"] is libtpu_installer.install()["installed"] is False
    # a new driver's stamp installs again, as a new channel does
    monkeypatch.setattr(nvml, "inventory", lambda: nvml.Inventory(
        tuple(card(i) for i in range(4)), "580.159.03", "13.0"))
    monkeypatch.setenv("LIBTPU_VERSION", "libtpu-2026-03-01")
    assert jinstaller.install()["installed"] and libtpu_installer.install()["installed"]
    # lost cards do not count
    monkeypatch.setattr(nvml, "inventory", lambda: inventory(
        [card(0), nvml.Card(1, "GPU-x", -1, "", 0, lost=True)]))
    assert libtpu_installer.install()["chips"] == 1


@pytest.mark.parametrize("cards", [4, 0, None])
async def test_installer_marker_gates_the_libtpu_component(host, monkeypatch, cards):
    """The marker is written only while NVML lists a live card (None: NVML
    fails), removed on shutdown; with it the port's libtpu component
    passes."""
    from tpu_operator_torch.validator import status

    if cards is None:
        monkeypatch.setattr(nvml, "inventory",
                            lambda: (_ for _ in ()).throw(nvml.NvmlError("no NVML")))
    else:
        monkeypatch.setattr(nvml, "inventory", lambda: inventory([card(i) for i in range(cards)]))
    task = await _serve_briefly(libtpu_installer.run)
    assert status.marker_exists(consts.LIBTPU_CTR_MARKER) == bool(cards)
    if cards:
        v = components.Validator(components.ValidatorConfig(
            node_name="", sleep_interval=0.01, resource_retries=2))
        await v.run("libtpu")
        ready = status.read_status("libtpu")
        assert (ready["chips"], ready["host_managed"]) == (4, False)
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    assert not status.marker_exists(consts.LIBTPU_CTR_MARKER)


# ---------------------------------------------------------------------------
# the VM runtime manager


def test_vm_runtime_dropins_are_byte_identical(tmp_path, monkeypatch):
    env = "kata-tpu=kata-tpu, fast=kata-clh,solo"
    assert vm_runtime_manager.parse_classes(env) == jvrm.parse_classes(env)
    classes = vm_runtime_manager.parse_classes(env)
    trees = {}
    for name, module in (("ref", jvrm), ("port", vm_runtime_manager)):
        monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path / name))
        conf = tmp_path / name / "etc" / "containerd" / "conf.d"
        changes = [module.stage(classes, "/etc/containerd/conf.d"),
                   module.stage(classes, "/etc/containerd/conf.d")]
        (conf / "tpu-vm-runtime-crashed.toml.tmp").write_text("version = 2\n")
        (conf / "other.toml").write_text("x")
        changes.append(module.stage(classes[:1], "/etc/containerd/conf.d"))
        trees[name] = (changes, {p.name: p.read_bytes() for p in sorted(conf.iterdir())})
    assert trees["port"] == trees["ref"]
    changes, files = trees["port"]
    assert changes == [3, 0, 3] and sorted(files) == ["other.toml", "tpu-vm-runtime-kata-tpu.toml"]
    for handler in ("kata-tpu", "kata-clh", "solo"):
        assert vm_runtime_manager.handler_config(handler) == jvrm.handler_config(handler)
