"""The port's tracer (``tpu_operator_torch/obs/trace.py``): finished spans
kept with their start, end, parent and attrs, up to a bound; ranges in the
profiler's trace only while a tracer and the profiler are both on; the
spans of the train step and of the rank launcher."""

import json

import pytest

torch = pytest.importorskip("torch")

from tpu_operator_torch.obs import trace  # noqa: E402
from tpu_operator_torch.workloads import _ranks, collectives  # noqa: E402


def _annotations(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_tracer_keeps_finished_spans_with_start_end_parent_and_attrs():
    tracer = trace.Tracer()
    with tracer.adopt(None):
        with trace.span("outer", tokens=8) as outer:
            with trace.span("inner", flops=3) as inner:
                assert inner.end is None and inner.duration_s is None
    kept = tracer.spans()
    assert [sp["name"] for sp in kept] == ["inner", "outer"]  # in the order they ended
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert inner.parent_id == outer.span_id and outer.parent_id == ""
    assert inner.trace_id == outer.trace_id
    assert (outer.attrs, inner.attrs) == ({"tokens": 8}, {"flops": 3})
    assert inner.duration_s == inner.end - inner.start
    assert kept == [inner.to_dict(), outer.to_dict()]
    d = kept[0]
    assert (d["name"], d["parent_id"], d["start"], d["end"], d["attrs"]) == (
        "inner", outer.span_id, inner.start, inner.end, {"flops": 3})


def test_no_tracer_keeps_nothing_and_opens_no_range(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("train.attn") as sp:
            torch.ones(4).sum()
    assert sp is None
    assert "train.attn" not in _annotations(prof, tmp_path)


def test_a_span_under_the_profiler_is_a_range_of_its_name(tmp_path):
    tracer = trace.Tracer()
    with tracer.adopt(None):
        with trace.span("train.mlp"):  # profiler off: no range
            pass
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.span("train.attn"):
                torch.ones(4).sum()
    names = _annotations(prof, tmp_path)
    assert names.count("train.attn") == 1 and "train.mlp" not in names
    assert [sp["name"] for sp in tracer.spans()] == ["train.mlp", "train.attn"]


def test_the_kept_spans_stop_at_the_bound_and_count_the_rest():
    tracer = trace.Tracer()
    tracer.KEEP = 3
    with tracer.adopt(None):
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
        trace.replay([{"name": "r", "span_id": "ab", "start": 0.0, "end": 1.0}], dropped=4)
    assert [sp["name"] for sp in tracer.spans()] == ["s0", "s1", "s2"]
    assert tracer.dropped == 2 + 1 + 4


def test_record_places_a_span_measured_elsewhere():
    tracer = trace.Tracer()
    with tracer.adopt(trace.TraceContext.parse("abc123-def456")):
        sp = tracer.record("ranks.rank_start", 1.0, 2.5, rank=3)
    assert (sp.start, sp.end, sp.duration_s) == (1.0, 2.5, 1.5)
    assert sp.parent_id == "def456" and sp.trace_id == "abc123" and sp.attrs == {"rank": 3}
    assert tracer.spans() == [sp.to_dict()]


def test_the_train_step_opens_its_four_spans():
    """One rank on the CPU: ``train.step`` (attr ``rank``) holds the two
    blocks and the gradients."""
    b, s, d, dh = 2, 8, 16, 32
    mesh = collectives.make_mesh(1, 0, torch.device("cpu"))
    params = collectives.transformer_params_from_jax(
        collectives.transformer_weights(d, dh, seed=1), mesh)
    x = torch.randn(b, s, d, dtype=torch.bfloat16)
    tracer = trace.Tracer()
    with tracer.adopt(None):
        collectives.transformer_step(mesh, 2, params, x)
    spans = {sp["name"]: sp for sp in tracer.spans()}
    assert set(spans) == {"train.step", "train.attn", "train.mlp", "train.grads"}
    step = spans.pop("train.step")
    assert all(sp["parent_id"] == step["span_id"] for sp in spans.values())
    assert step["attrs"] == {"rank": 0}
    assert all(sp["attrs"] == {} for sp in spans.values())
    order = ["train.attn", "train.mlp", "train.grads"]
    assert [spans[n]["start"] for n in order] == sorted(spans[n]["start"] for n in order)
    assert [spans[n]["end"] for n in order] == sorted(spans[n]["end"] for n in order)
    # untraced, the same step keeps nothing anywhere
    collectives.transformer_step(mesh, 2, params, x)
    assert len(tracer.spans()) == 4


def _rank_tracer(rank, world_size, device):
    with trace.span("probe") as sp:
        return {"traced": sp is not None}


def test_ranks_hand_their_spans_to_the_callers_tracer():
    tracer = trace.Tracer()
    with tracer.adopt(None):
        out = _ranks.run(_rank_tracer, 4, "cpu", timeout_s=120)
    assert out == {"traced": True}
    spans = tracer.spans()
    (run,) = [sp for sp in spans if sp["name"] == "ranks.run"]
    # what each rank's fn opened came back too, under the run
    probes = [sp for sp in spans if sp["name"] == "probe"]
    assert len(probes) == 4 and all(sp["parent_id"] == run["span_id"] for sp in probes)
    for name in ("ranks.rank_start", "ranks.rendezvous"):
        mine = [sp for sp in spans if sp["name"] == name]
        assert sorted(sp["attrs"]["rank"] for sp in mine) == [0, 1, 2, 3]
        assert all(sp["parent_id"] == run["span_id"] and sp["trace_id"] == run["trace_id"]
                   for sp in mine)
    # every rank started after the run opened and met after it started
    starts = {sp["attrs"]["rank"]: sp for sp in spans if sp["name"] == "ranks.rank_start"}
    for sp in spans:
        if sp["name"] == "ranks.rendezvous":
            assert run["start"] <= starts[sp["attrs"]["rank"]]["end"] <= sp["start"]
            assert sp["end"] <= run["end"]


def test_untraced_ranks_trace_nothing():
    assert _ranks.run(_rank_tracer, 4, "cpu", timeout_s=120) == {"traced": False}
