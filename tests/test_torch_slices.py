"""The port's partitions of whole cards (``tpu_operator_torch/slices.py``)
and slice manager against the reference's, on the same inputs: the
reference's ``tests/test_slices.py`` cases and Hypothesis-drawn tilings of
1-3-axis meshes must give the same layout or the same error text (the
reference's ``all-isolated`` profile on 2x2 included, which fails on
purpose in both), and both slice managers, each through a recording fake
client, the same label patches, layout file and evictions.  The one
difference on purpose: the reference evicts pods asking for
``google.com/tpu``, the port pods asking for ``nvidia.com/gpu`` (and its
``-<shape>`` units).  Exact equality: no tolerance."""

import asyncio
import copy
import json

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_operator import consts as jconsts
from tpu_operator import slices as jslices
from tpu_operator.agents import slice_manager as jmanager
from tpu_operator_torch import consts, slices
from tpu_operator_torch.agents import slice_manager as tmanager


def outcome(fn, *args):
    """The result, or the error's type name and text."""
    try:
        out = fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)
    if out and hasattr(out[0], "coords"):
        out = [(p.shape, p.origin, p.chips, p.coords()) for p in out]
    return "ok", out


def same(fn_name, *args):
    mine = outcome(getattr(slices, fn_name), *args)
    ref = outcome(getattr(jslices, fn_name), *args)
    assert mine == ref
    return mine


@pytest.mark.parametrize("topology, shapes", [
    ("4x4x4", ["2x4x4", "2x4x4"]), ("2x4", ["2x2", "2x2"]), ("4x4x4", ["2x4x4"]),
    ("4x4", ["3x4", "1x4"]), ("4x4", ["2x3", "2x3", "2x2"]), ("4x4x4", ["4x4"] * 4),
    ("2x2", ["1x1"]), ("1x1", ["1x1"]), ("2x2", ["1x2", "1x2"]), ("2x2", ["1x1"] * 4),
    ("2x4", ["1x4", "1x4"]), ("2x2", []), ("4x4", ["4x2", "2x2", "2x2"]), ("2xq", ["1x1"]),
])
def test_partition_topology_matches_reference(topology, shapes):
    same("partition_topology", topology, shapes)


def test_all_isolated_on_2x2_fails_as_the_reference():
    """The reference's default all-isolated profile (["1x1"]) tiles only a
    1x1 mesh: both packages refuse it on 2x2 with the same text."""
    assert same("chip_assignments", "2x2", ["1x1"], 4) == (
        "PartitionError", "shapes ['1x1'] cover 1 chips; topology 2x2 has 4")
    assert same("chip_assignments", "1x1", ["1x1"], 1)[0] == "ok"


@pytest.mark.parametrize("topology, shapes, per_host", [
    ("2x4", ["2x2", "2x2"], 4), ("2x4", ["1x4", "1x4"], 4), ("2x4", ["2x2", "2x2"], 0),
    ("2x4", ["2x2", "2x2"], 3), ("2x2", ["1x2", "1x2"], 4), ("2x4", ["1x2"] * 4, 4),
    ("4x4x4", ["2x4x4", "2x4x4"], 4), ("2x2", ["1x1"], 4),
])
def test_chip_assignments_match_reference(topology, shapes, per_host):
    same("chip_assignments", topology, shapes, per_host)


PROFILES = {"slice-configs": {
    "v5p-only": [{"accelerators": ["tpu-v5p-slice"], "topology": "4x4x4",
                  "partitions": ["2x4x4", "2x4x4"]}],
    "all-balanced": [{"accelerators": ["tpu-v5p-slice"], "topology": "4x4x4",
                      "partitions": ["2x4x4", "2x4x4"]},
                     {"accelerators": ["*"], "partitions": []}],
}}


@pytest.mark.parametrize("config, profile, accel, topo", [
    (PROFILES, "absent", "tpu-v5p-slice", "4x4x4"),
    (PROFILES, "v5p-only", "tpu-v5-lite-podslice", "2x4"),
    ({}, "anything", "x", "y"),
    (PROFILES, "all-balanced", "tpu-v5p-slice", "4x4x4"),
    (PROFILES, "all-balanced", "tpu-v5-lite-podslice", "2x4"),
    (PROFILES, "v5p-only", "tpu-v5p-slice", "4x4x4"),
])
def test_load_profile_matches_reference(config, profile, accel, topo):
    same("load_profile", config, profile, accel, topo)


meshes = st.lists(st.integers(1, 4), min_size=1, max_size=3)


@settings(max_examples=60, deadline=None)
@given(meshes, st.data())
def test_drawn_tilings_match_reference(mesh, data):
    """A box that divides every axis, repeated to fill the mesh, and then
    the same list with one box's shape redrawn (mostly an error)."""
    box = [data.draw(st.sampled_from([d for d in range(1, m + 1) if m % d == 0]))
           for m in mesh]
    topology = "x".join(map(str, mesh))
    count = 1
    for m, b in zip(mesh, box):
        count *= m // b
    shapes = ["x".join(map(str, box))] * count
    per_host = data.draw(st.integers(0, 8))
    assert same("chip_assignments", topology, shapes, per_host)[0] == "ok"
    odd = data.draw(st.lists(st.integers(1, 4), min_size=1, max_size=3))
    shapes[data.draw(st.integers(0, count - 1))] = "x".join(map(str, odd))
    same("chip_assignments", topology, shapes, per_host)


@settings(max_examples=60, deadline=None)
@given(meshes, st.lists(st.lists(st.integers(1, 4), min_size=1, max_size=3), max_size=6))
def test_drawn_shape_lists_match_reference(mesh, shapes):
    same("partition_topology", "x".join(map(str, mesh)), ["x".join(map(str, s)) for s in shapes])


# ---------------------------------------------------------------------------
# the slice manager


class RecordingClient:
    """get, patch (merge), list_items with a ``spec.nodeName`` field
    selector, and delete, on Nodes and Pods in memory; records each patch
    and deletion."""

    def __init__(self, node: dict, pods: list):
        self.objects = {("Node", "", node["metadata"]["name"]): node}
        for pod in pods:
            self.objects[("Pod", pod["metadata"]["namespace"], pod["metadata"]["name"])] = pod
        self.patches, self.deleted = [], []

    async def get(self, group, kind, name, namespace=None):
        return copy.deepcopy(self.objects[(kind, namespace or "", name)])

    async def patch(self, group, kind, name, patch, namespace=None):
        self.patches.append(copy.deepcopy(patch))
        obj = self.objects[(kind, namespace or "", name)]
        for key, value in patch["metadata"].items():
            obj["metadata"].setdefault(key, {}).update(value)
        return copy.deepcopy(obj)

    async def list_items(self, group, kind, namespace=None, field_selector=None, **kw):
        node = field_selector.split("=", 1)[1]
        return [copy.deepcopy(o) for (k, _, _), o in sorted(self.objects.items())
                if k == kind and o["spec"].get("nodeName") == node]

    async def delete(self, group, kind, name, namespace=None):
        self.deleted.append((namespace, name))
        self.objects.pop((kind, namespace or "", name))


def pod(name, node, resource=None, daemonset=False):
    meta = {"name": name, "namespace": "default", "uid": f"uid-{name}"}
    if daemonset:
        meta["ownerReferences"] = [{"kind": "DaemonSet", "name": "operand"}]
    limits = {resource: "1"} if resource else {}
    return {"metadata": meta, "spec": {"nodeName": node, "containers": [
        {"name": "c", "resources": {"limits": limits}}]}}


CONFIG = {"version": "v1", "slice-configs": {
    "all-disabled": [{"accelerators": ["*"], "partitions": []}],
    "all-isolated": [{"accelerators": ["*"], "partitions": ["1x1"]}],
    "halves": [{"accelerators": ["*"], "topology": "2x2", "partitions": ["1x2", "1x2"]}],
    "quarters": [{"accelerators": ["*"], "topology": "2x2", "partitions": ["1x1"] * 4}],
    "bad": [{"accelerators": ["*"], "partitions": ["3x3"]}],
}}


def run_manager(module, labels_mod, tmp_path, monkeypatch, resource, labels, steps):
    """Drive ``module``'s SliceManager through ``steps`` (a profile or a
    ConfigMap edit each) on one node; returns what each step did."""
    root = tmp_path / resource.replace("/", "_")
    (root / "validations").mkdir(parents=True)
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(root))
    config_file = root / "config.yaml"
    config_file.write_text(yaml.safe_dump(CONFIG))
    node = {"metadata": {"name": "node-0", "labels": dict(labels)}}
    pods = [pod("train", "node-0", resource), pod("unit", "node-0", resource + "-1x2"),
            pod("operand", "node-0", resource, daemonset=True), pod("web", "node-0"),
            pod("elsewhere", "node-1", resource)]
    client = RecordingClient(node, pods)
    mgr = module.SliceManager(client, "node-0", str(config_file))
    out = []
    for step in steps:
        if isinstance(step, dict):
            config_file.write_text(yaml.safe_dump(step))
            profile = None
        else:
            profile = step
        if profile is not None:
            client.objects[("Node", "", "node-0")]["metadata"]["labels"][
                labels_mod.SLICE_CONFIG_LABEL] = profile
        state = asyncio.run(mgr.sync_once())
        try:
            layout = json.loads((root / "slice_config.json").read_text())
        except OSError:
            layout = None
        out.append((state, layout, list(client.patches), list(client.deleted)))
        client.patches.clear()
    return out


EDITED = {"slice-configs": {**CONFIG["slice-configs"],
                            "halves": [{"accelerators": ["*"], "partitions": ["2x1", "2x1"]}]}}


@pytest.mark.parametrize("labels, steps", [
    ({"topology": "2x2", "count": "4"}, ["all-disabled", "all-disabled", "halves", "halves",
                                         EDITED, "all-isolated", "quarters", "bad"]),
    ({"topology": "1x1", "count": "1"}, ["all-isolated", "all-isolated", "all-disabled"]),
    ({"topology": "", "count": "4"}, ["halves", "all-disabled"]),
    ({"topology": "2x4", "count": ""}, ["halves", "missing"]),
    ({"topology": "2x2", "count": "four"}, ["quarters"]),
])
def test_slice_manager_matches_reference(tmp_path, monkeypatch, labels, steps):
    def node_labels(mod):
        out = {mod.GKE_TPU_ACCELERATOR_LABEL: "tpu-v5-lite-podslice"}
        if labels["topology"]:
            out[mod.GKE_TPU_TOPOLOGY_LABEL] = labels["topology"]
        if labels["count"]:
            out[mod.TPU_COUNT_LABEL] = labels["count"]
        return out

    ref = run_manager(jmanager, jconsts, tmp_path, monkeypatch, "google.com/tpu",
                      node_labels(jconsts), steps)
    mine = run_manager(tmanager, consts, tmp_path, monkeypatch, "nvidia.com/gpu",
                       node_labels(consts), steps)
    assert mine == ref
    states = [state for state, *_ in mine]
    if steps[:2] == ["all-disabled", "all-disabled"]:
        assert states == ["success", None, "success", None, "success", "failed", "success",
                          "failed"]
        # the DaemonSet's pod, the pod off the node and the pod asking for
        # no card stay; the card pods go before the first layout is written
        assert mine[0][3] == [("default", "train"), ("default", "unit")]
        # a failed profile leaves the layout as it was
        assert mine[5][1] == mine[4][1] and mine[7][1] == mine[6][1]
        assert [p["shape"] for p in mine[2][1]["partitions"]] == ["1x2", "1x2"]
        assert [p["chip_ids"] for p in mine[2][1]["partitions"]] == [[0, 1], [2, 3]]
        assert [p["shape"] for p in mine[4][1]["partitions"]] == ["2x1", "2x1"]
        assert mine[2][2] == [
            {"metadata": {"labels": {consts.SLICE_CONFIG_STATE_LABEL: s}}}
            for s in ("pending", "success")]
