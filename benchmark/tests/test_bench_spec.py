"""BENCHMARK.json against the contract's shape, and every file it names
found by name: a cell, a configuration, a traffic mix or a metric added as
files is found without an edit to any other file."""

import json
import math
import os
import re
import shutil

from benchmark.spec import Spec, kind

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names(spec):
    b = spec.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(spec):
    for w in spec.bench["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.per_layer(w["name"])
        assert layers
        for m in layers:  # the metric each moves is one the cell reports
            assert m["moves"] in e2e


def test_the_full_check_fits_its_time_with_24_cells(spec):
    runs = 2 + 14 * 24
    total = runs * (spec.bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_every_named_file_is_found(spec):
    for c in spec.bench["configs"]:
        assert os.path.exists(os.path.join(spec.root, c["file"]))
        assert spec.config(c["name"])["name"] == c["name"]
    for w in spec.bench["workloads"]:
        traffic = spec.traffic(w["traffic"])
        assert hasattr(kind(traffic["kind"]), "run")
        assert spec.cell(w["name"])["limits"]
    for m in spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_configs_keep_the_published_widths(spec):
    layer = spec.config("gpt3-6.7b-layer")
    assert (layer["d_model"], layer["n_heads"], layer["d_head"], layer["d_ff"]) == (
        4096, 32, 128, 16384)
    assert set(layer["reduced"]) == set(layer["published"])
    gate = spec.config("gate-h100")
    assert gate["vector_add_n"] == 1 << 20 and gate["allreduce_mb"] == 64


def test_a_new_cell_and_metric_are_found_as_files_alone(spec, tmp_path):
    """A copy of the benchmark's files, then only additions: a traffic mix,
    a cell, a configuration and a metric reader, each a new file, and their
    entries in BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.dir, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(spec.bench))
    (root / "benchmark" / "configs" / "new-model.json").write_text(
        json.dumps(dict(spec.config("gpt3-6.7b-layer"), name="new-model")))
    (root / "benchmark" / "traffic" / "train.b2.s512.mesh1x1.json").write_text(
        json.dumps(dict(spec.traffic("train.b4.s2048.mesh1x1"), batch_per_dp=2,
                        seq_per_mp=512)))
    (root / "benchmark" / "cells" / "new.x1.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    (root / "benchmark" / "metrics" / "new.steps.py").write_text(
        "def read(ctx):\n    return ctx.get('steps')\n")
    bench["configs"].append({"name": "new-model", "source": "https://example.org",
                             "file": "benchmark/configs/new-model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new.x1", "config": "new-model",
                               "traffic": "train.b2.s512.mesh1x1", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("new.x1")
    bench["per_layer"].append({"name": "new.steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "train_tokens_per_s", "workloads": ["new.x1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    new = Spec(str(root))
    w = new.workload("new.x1")
    assert new.config(w["config"])["name"] == "new-model"
    assert new.traffic(w["traffic"])["seq_per_mp"] == 512
    assert new.cell("new.x1")["limits"] == {"loss_gap": 1.0}
    assert [m["name"] for m in new.per_layer("new.x1")] == ["new.steps"]
    assert new.reader("new.steps")({"steps": 7}) == 7
    assert "train_tokens_per_s" in {m["name"] for m in new.end_to_end("new.x1")}
    # the original cells are as they were
    assert [m["name"] for m in new.per_layer("train.s2048.x1")] == [
        m["name"] for m in spec.per_layer("train.s2048.x1")]


def test_run_seconds_and_bounds_are_whole_and_sane(spec):
    assert spec.bench["run_seconds"] == math.floor(spec.bench["run_seconds"])
    setup = [m for m in spec.bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
