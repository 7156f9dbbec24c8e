"""The language model on the training path (``workloads/lm.py``, the expert
layer of ``workloads/moe.py``, the sliding window of the ring-attention
path) against the benchmark's plain reference (``benchmark/reference/
k_exaone.py``) and against dense formulas, at tiny sizes on the CPU; the
benchmark's runner, faults and span readers of the new cell.
"""

import dataclasses
import math
import time

import pytest

torch = pytest.importorskip("torch")

from benchmark import compare_lm, counts, counts_lm, faults_lm, phases, phases_lm  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from benchmark.harness import execute  # noqa: E402
from benchmark.kinds import lm_train  # noqa: E402
from benchmark.reference import k_exaone as reference  # noqa: E402
from benchmark.spec import Spec  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.kernels import flash_backward as fb  # noqa: E402
from tpu_operator_torch.obs import trace  # noqa: E402
from tpu_operator_torch.workloads import collectives, lm, moe  # noqa: E402
from tpu_operator_torch.workloads import ring_attention as ra  # noqa: E402

CELL = "k-exaone.s4096.x1"
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are
# the model at a size the CPU runs in a second: d 64, 8 q / 2 kv heads of
# 16, window 8, 16 experts of width 32 (8 held, the first share of two),
# top-4, a shared expert of width 32, vocabulary 97, 2 sequences of 48
TINY = dict(hidden_size=64, num_attention_heads=8, num_key_value_heads=2, head_dim=16,
            sliding_window=8, num_experts=8, expert_parallel=2, num_experts_per_tok=4,
            moe_intermediate_size=32, intermediate_size=128, vocab_size=97)
# float32 on both sides in another order of operations (flattened batch
# against a sequence at a time, fused against blocked attention): a few
# ulps a product, grown through five layers and their backward
LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-5  # of the leaf's largest |reference gradient|
# a change of 1e-3 to 1e-5 of a weight near 1 (the embedding, the gains)
# keeps 7 to 2 of its float32 digits on each side
CHANGE_RTOL = 1e-4


@pytest.fixture
def tiny():
    spec = Spec()
    w = spec.workload(CELL)
    config = dict(spec.config(w["config"]), **TINY)
    traffic = dict(spec.traffic(w["traffic"]), batch_per_dp=2, seq_per_mp=48,
                   traced_seconds=0.05)
    return config, traffic


@pytest.fixture(autouse=True)
def _unplanted():
    """A fault planted by a run's patch goes with its test."""
    saved = lm.LMConfig.__dict__["from_dict"], lm.train_step
    yield
    lm.LMConfig.from_dict, lm.train_step = saved


def _mesh():
    return collectives.make_mesh(1, 0, torch.device("cpu"))


def test_the_program_holds_the_reference_leaves(tiny):
    config, _ = tiny
    assert lm.shapes(lm.LMConfig.from_dict(config)) == reference.shapes(reference.model(config))


def test_the_program_names_the_benchmark_configuration():
    """``train_bench`` runs the configuration by name from the program's own
    copy, which must be the benchmark's in every key the model reads."""
    spec = Spec()
    bench = spec.config(spec.workload(CELL)["config"])
    mine = lm.MODELS["k-exaone-236b-a23b-ep16"]
    assert lm.LMConfig.from_dict(mine) == lm.LMConfig.from_dict(bench)
    assert {k: bench[k] for k in mine if k not in ("layer_types", "mlp_layer_types")} == \
        {k: v for k, v in mine.items() if k not in ("layer_types", "mlp_layer_types")}


def test_train_step_matches_the_reference(tiny):
    """The step's loss and every leaf's gradient against the reference's;
    the step's update is w − lr·g of those gradients; after two steps each
    leaf's change matches the reference's."""
    config, traffic = tiny
    weights = lm_train.draw_weights(config, SEED, "cpu")
    batches = lm_train.draw_batches(config, traffic, SEED, "cpu", 2)
    model, lr, mesh = lm.LMConfig.from_dict(config), config["lr"], _mesh()
    leaves = {n: w.clone().requires_grad_() for n, w in weights.items()}
    count = batches[0].shape[0] * (batches[0].shape[1] - 1)
    share = lm.forward_loss(model, leaves, batches[0], mesh, False, count)
    grads = dict(zip(leaves, torch.autograd.grad(share, list(leaves.values()))))
    ref_loss, ref_grads = reference.loss_and_grads(reference.model(config), weights, batches[0],
                                                   rows=16)
    assert abs(float(share.detach()) - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    assert math.isclose(ref_loss, math.log(config["vocab_size"]), rel_tol=0.5)
    for name, g in ref_grads.items():
        assert float(g.abs().max()) > 0, name
        assert float((grads[name] - g).abs().max()) <= GRAD_RTOL * float(g.abs().max()), name
    loss, params = lm.train_step(mesh, model, weights, batches[0], lr)
    assert torch.equal(loss, share.detach())
    for name, w in weights.items():
        assert torch.equal(params[name], w - lr * grads[name]), name
    loss2, params = lm.train_step(mesh, model, params, batches[1], lr)
    ref = reference.train(config, weights, batches, lr, steps=2, rows=16)
    assert abs(float(loss2) - ref["losses"][1]) <= LOSS_RTOL * abs(ref["losses"][1])
    for name, w0 in weights.items():
        change = float((params[name] - w0).double().norm())
        assert math.isclose(change, ref["change_norms"][name], rel_tol=CHANGE_RTOL), name


def test_expert_shares_add_up_to_the_uncut_layer(tiny):
    """Every card's share of an expert layer, with the shared expert counted
    once, adds up to the reference's layer over all 16 experts."""
    config, _ = tiny
    m = reference.model(config)
    gen = torch.Generator().manual_seed(7)
    d, f, n_all = m.d, m.expert, m.experts
    w = {"l1.router": torch.randn(d, n_all, generator=gen) / 8,
         "l1.shared.w_gate": torch.randn(d, f, generator=gen) / 8,
         "l1.shared.w_up": torch.randn(d, f, generator=gen) / 8,
         "l1.shared.w_down": torch.randn(f, d, generator=gen) / 6}
    for part, shape in (("w_gate", (n_all, d, f)), ("w_up", (n_all, d, f)),
                        ("w_down", (n_all, f, d))):
        w["l1.experts." + part] = torch.randn(shape, generator=gen) / 8
    x = torch.randn(96, d, generator=gen)
    uncut = reference.expert_layer(m, w, "l1.", x, tf32=False, first=0)
    model = lm.LMConfig.from_dict(config)
    experts, weights = moe.route_sigmoid_topk(x, w["l1.router"], model.top_k, model.normalize,
                                              model.routed_scale)
    total = moe.swiglu(x, w["l1.shared.w_gate"], w["l1.shared.w_up"], w["l1.shared.w_down"])
    pairs = 0
    for share in range(config["expert_parallel"]):
        held = slice(share * m.held, (share + 1) * m.held)
        part, counts_ = moe.held_experts(x, experts, weights, share * m.held,
                                         *(w["l1.experts." + p][held]
                                           for p in ("w_gate", "w_up", "w_down")))
        total = total + part
        pairs += sum(counts_)
    assert pairs == x.shape[0] * model.top_k  # dropless: every pair on some card
    assert float((total - uncut).abs().max()) <= 1e-5 * float(uncut.abs().max())


def test_router_follows_its_formula_through_near_ties():
    """s = sigmoid(x·Wr); the top k of s; w = s / (Σ s + 1e-20) · scale.  Two
    experts one float32 step apart in score: the larger is chosen."""
    x = torch.eye(4)
    logits = torch.tensor([[0.5, 0.25, -1.0, 2.0, 0.1]] * 4)
    # expert 4's logit stepped up from expert 1's until its score is the
    # next float32 above: the two scores one step apart for token 0
    near, tied = torch.tensor(0.25), torch.sigmoid(torch.tensor(0.25))
    while torch.sigmoid(near) <= tied:
        near = torch.nextafter(near, torch.tensor(1.0))
    assert torch.sigmoid(near) == torch.nextafter(tied, torch.tensor(1.0))
    logits[0, 4] = float(near)
    experts, weights = moe.route_sigmoid_topk(x, logits, 3, True, 2.5)
    assert sorted(experts[0].tolist()) == [0, 3, 4]
    assert sorted(experts[1].tolist()) == [0, 1, 3]
    s = torch.sigmoid(logits)
    for row in range(4):
        chosen = s[row, experts[row]]
        assert torch.allclose(weights[row], chosen / (chosen.sum() + 1e-20) * 2.5, rtol=0,
                              atol=1e-7)
    assert torch.allclose(weights.sum(-1), torch.full((4,), 2.5))
    experts, weights = moe.route_sigmoid_topk(x, logits, 3, False, 1.0)
    assert torch.equal(weights, s.gather(1, experts))  # unnormalised: the scores themselves


def _dense(q, k, v, window):
    """softmax(q kᵀ/√D) v under the causal mask and the window, [B, T, H, D]."""
    t = q.shape[1]
    gap = torch.arange(t)[:, None] - torch.arange(t)[None, :]
    keep = (gap >= 0) & (gap < window) if window else gap >= 0
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.masked_fill(~keep, -math.inf), -1), v)


@pytest.mark.parametrize("window", [3, 16, 40, 64], ids=["w3", "w16", "w40", "w64>T"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["ring", "flash-plain"])
def test_windowed_ring_path_matches_a_dense_masked_softmax(window, use_kernel):
    """The remat ring path on one rank (the plain ring, or the kernels'
    plain versions) with a window under, at and over the block, values and
    gradients."""
    gen = torch.Generator().manual_seed(window)
    q, k, v = (torch.randn(2, 40, 3, 16, generator=gen, dtype=torch.float64).float()
               .requires_grad_() for _ in range(3))
    dout = torch.randn(2, 40, 3, 16, generator=gen)
    out = ra.ring_attention_remat(q, k, v, True, use_kernel, None, window)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    want = _dense(q, k, v, window if window < 40 else 0)
    want_grads = torch.autograd.grad(want, (q, k, v), dout)
    assert float((out - want).detach().abs().max()) <= 1e-5
    for g, h in zip(grads, want_grads):
        assert float((g - h).abs().max()) <= 1e-5 * float(h.abs().max())


@pytest.mark.parametrize("window", [5, 16, 24, 100])
def test_windowed_hops_at_offsets_add_up_to_the_dense_attention(window):
    """A sequence of 48 in blocks of 16: each query block folds the key
    blocks at their offsets (B3's plain version) and takes each hop's
    backward (B4's): the result and the gradients are the dense masked
    attention's, the hops wholly outside the band included."""
    gen = torch.Generator().manual_seed(window)
    bh, t, d, blk = 3, 48, 16, 16
    q, k, v = (torch.randn(bh, t, d, generator=gen).requires_grad_() for _ in range(3))
    dout = torch.randn(bh, t, d, generator=gen)
    want = _dense(*(x.transpose(0, 1)[None] for x in (q, k, v)), window)[0].transpose(0, 1)
    want_grads = torch.autograd.grad(want, (q, k, v), dout)
    out, lse = torch.zeros(bh, t, d), torch.zeros(bh, t)
    for i in range(0, t, blk):
        m, l, o = torch.full((bh, blk), fa.NEG_INF), torch.zeros(bh, blk), torch.zeros(bh, blk, d)
        for j in range(0, t, blk):
            m, l, o = fa.flash_block_update_reference(
                q[:, i:i + blk].detach(), k[:, j:j + blk].detach(), v[:, j:j + blk].detach(), i, j,
                m, l, o, True, window)
        out[:, i:i + blk], lse[:, i:i + blk] = o / l[..., None], m + torch.log(l)
    assert float((out - want).detach().abs().max()) <= 1e-5
    dsum = (dout * out).sum(-1)
    dq, dk, dv = torch.zeros(bh, t, d), torch.zeros(bh, t, d), torch.zeros(bh, t, d)
    for i in range(0, t, blk):
        for j in range(0, t, blk):
            rows, keys = slice(i, i + blk), slice(j, j + blk)
            dq[:, rows], dk[:, keys], dv[:, keys] = fb.flash_block_backward_reference(
                q[:, rows].detach(), k[:, keys].detach(), v[:, keys].detach(), dout[:, rows],
                lse[:, rows], dsum[:, rows], dq[:, rows], dk[:, keys], dv[:, keys], i, j, True,
                window)
    for g, h in zip((dq, dk, dv), want_grads):
        assert float((g - h).abs().max()) <= 1e-5 * float(h.abs().max())


def test_a_window_needs_a_causal_hop():
    q = torch.zeros(1, 16, 8)
    state = (torch.zeros(1, 16), torch.zeros(1, 16), torch.zeros(1, 16, 8))
    with pytest.raises(ValueError, match="window"):
        fa.flash_block_update(q, q, q, 0, 0, *state, False, 4)


def test_rope_on_sliding_layers_only(tiny, monkeypatch):
    """EXAONE 4.0 with a window: rotary positions on the sliding layers (0,
    1, 2, 4: q and k each), none on the global one (3)."""
    config, traffic = tiny
    model = lm.LMConfig.from_dict(config)
    assert [x.rope for x in model.layers] == [True, True, True, False, True]
    assert [x.window for x in model.layers] == [8, 8, 8, 0, 8]
    assert [x.dense for x in model.layers] == [True, False, False, False, False]
    calls = []
    rotary = lm.rotary
    monkeypatch.setattr(lm, "rotary", lambda x, *a: calls.append(x.shape) or rotary(x, *a))
    params = lm_train.draw_weights(config, SEED, "cpu")
    ids = lm_train.draw_batches(config, traffic, SEED, "cpu", 1)[0]
    with trace.Tracer().adopt(None) as tracer:
        lm.forward_loss(model, params, ids, _mesh(), False, 96)
    heads = [sp["attrs"]["layer"] for sp in tracer.spans() if sp["name"] == "train.attn"]
    assert heads == [0, 1, 2, 3, 4] and len(calls) == 8
    # a shift of every position moves a sliding layer's scores only if it
    # sees positions: the global layer's output is the same at any offset
    x = torch.randn(1, 12, model.d_model)
    layer = model.layers[3]
    outs = [lm._attention(model, layer, params, "l3.", x, torch.arange(12) + shift, _mesh(),
                          False) for shift in (0, 5)]
    assert torch.equal(outs[0], outs[1])
    layer = model.layers[0]
    outs = [lm._attention(model, layer, params, "l0.", x, torch.arange(12) + shift, _mesh(),
                          False) for shift in (0, 5)]
    assert not torch.equal(outs[0], outs[1])


def test_spans_and_counts_of_the_step(tiny):
    """The spans the step opens are the ``train.*`` ranges the readers give
    device time to, and ``train.moe`` counts its pairs, load and host
    reads, one read a layer."""
    config, traffic = tiny
    model = lm.LMConfig.from_dict(config)
    params = lm_train.draw_weights(config, SEED, "cpu")
    ids = lm_train.draw_batches(config, traffic, SEED, "cpu", 1)[0]
    with trace.Tracer().adopt(None) as tracer:
        lm.train_step(_mesh(), model, params, ids, 0.05)
    spans = tracer.spans()
    names = {sp["name"] for sp in spans}
    assert names == {"train.step", "train.attn", "train.ffn", "train.moe", "train.moe.route",
                     "train.moe.experts", "train.moe.shared", "train.head", "train.grads"}
    assert all(n.startswith(phases.PREFIX) for n in names)
    moes = [sp["attrs"] for sp in spans if sp["name"] == "train.moe"]
    assert [a["layer"] for a in moes] == [1, 2, 3, 4]
    for a in moes:
        assert a["host_reads"] == 1 and 0 < a["max_load"] <= a["routed_pairs"]
        assert a["routed_pairs"] <= ids.numel() * model.top_k


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
            "args": args}


def test_phases_lm_gives_device_time_to_every_span():
    """A hand-written window: a forward launch in ``train.moe.experts``,
    its backward node's launch on the autograd thread, one in
    ``train.attn`` and one in ``train.head``; 10 µs outside every span."""
    events = [
        _x(btrace.WINDOW, "user_annotation", 0, 1000),
        _x("train.step", "user_annotation", 0, 900),
        _x("train.attn", "user_annotation", 10, 90),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 2, correlation=1),
        _x("train.moe", "user_annotation", 100, 200),
        _x("train.moe.experts", "user_annotation", 110, 100),
        _x("aten::mm", "cpu_op", 120, 20, **{"Sequence number": 4, "Fwd thread id": 0}),
        _x("cudaLaunchKernel", "cuda_runtime", 125, 2, correlation=2),
        _x("train.head", "user_annotation", 300, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 2, correlation=3),
        _x("MmBackward0", "cpu_op", 500, 20, 2, **{"Sequence number": 4, "Fwd thread id": 1}),
        _x("cudaLaunchKernel", "cuda_runtime", 505, 2, 2, correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 950, 2, correlation=5),
    ] + [_x("k", "kernel", ts, dur, 99, correlation=c)
         for c, ts, dur in ((1, 30, 40), (2, 130, 100), (3, 320, 20), (4, 510, 100), (5, 960, 10))]
    table = phases_lm.attribute(events)
    assert table == pytest.approx({"train.attn": 40e-6, "train.moe.experts": 200e-6,
                                   "train.head": 20e-6, phases.NONE: 10e-6})
    assert phases_lm.share(table, "train.moe") == pytest.approx(100 * 200 / 270)
    assert phases_lm.attribute([e for e in events if not e["name"].startswith("train.")]) == {}


def test_window_pairs_count_the_band():
    for t, w in ((48, 5), (64, 16), (40, 100)):
        gap = torch.arange(t)[:, None] - torch.arange(t)[None, :]
        assert counts_lm.window_pairs(t, t, 0, 0, w) == int(((gap >= 0) & (gap < w)).sum())
    assert counts_lm.window_pairs(64, 64, 0, 0, 0) == counts.causal_pairs(64, 64, 0, 0)
    assert counts_lm.window_pairs(16, 16, 64, 0, 8) == 0  # the band ends before the block
    flops = counts_lm.step_model_flops(lm.MODELS["k-exaone-236b-a23b-ep16"], 4, 4096)
    assert 1.15e14 < flops < 1.35e14  # ~7.5 GFLOP a token


def test_runner_is_correct_at_a_tiny_size_and_reads_its_spans(tiny):
    config, traffic = tiny
    out = execute(Spec(), CELL, SEED, 0.3, True, time.monotonic(), device="cpu", config=config,
                  traffic=traffic)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["compared"]) == set(Spec().cell(CELL)["limits"]) >= {"token_loss_gap"}
    load = out["layer"]["lm"]["load"]
    assert load["host_reads"] == load["moe_layers"] == 4 * out["layer"]["traced_steps"]
    assert set(out["end_to_end"]) >= {"setup_s", "train_tokens_per_s"}


@pytest.mark.parametrize("fault", faults_lm.FAULTS + ("state_unchanged",))
def test_each_fault_makes_the_runner_incorrect(tiny, fault):
    config, traffic = tiny
    out = execute(Spec(), CELL, SEED, 0.05, False, time.monotonic(), device="cpu",
                  config=config, traffic=traffic, patch=f"benchmark.faults_lm:{fault}")
    assert not out["correct"], out["compared"]


def test_token_losses_are_the_reference_s_and_add_up_to_the_loss(tiny):
    """The program's per-token losses (the first step's forward, no
    gradient) against the reference's, token by token; their mean is the
    step's loss."""
    config, traffic = tiny
    weights = lm_train.draw_weights(config, SEED, "cpu")
    ids = lm_train.draw_batches(config, traffic, SEED, "cpu", 1)[0]
    model, mesh = lm.LMConfig.from_dict(config), _mesh()
    mine = lm.token_losses(mesh, model, weights, ids)
    ref = reference.token_losses(config, weights, ids, rows=16)
    assert mine.shape == ref.shape == (ids.shape[0], ids.shape[1] - 1)
    assert float(((mine - ref).abs() / ref).max()) <= LOSS_RTOL * 10
    loss, _ = lm.train_step(mesh, model, weights, ids, config["lr"])
    assert math.isclose(float(mine.double().mean()), float(loss), rel_tol=LOSS_RTOL)


def test_token_gap_is_the_first_quartile_and_blind_to_a_few_tokens():
    """``token_loss_gap`` reads the first quartile of the tokens' gaps: a
    few tokens moved by a whole term (near-tie flips) leave it where it
    was, every token moved a little (a precision lost everywhere) moves
    it."""
    gen = torch.Generator().manual_seed(5)
    ref = 9.0 + torch.rand(4, 64, generator=gen, dtype=torch.float64)
    noise = torch.randn(4, 64, generator=gen, dtype=torch.float64)
    program = ref * (1 + 1e-7 * noise)
    floor = compare_lm.token_gap(program, ref)
    assert 1e-9 < floor < 1e-7
    flipped = program.clone()
    flipped.view(-1)[torch.randperm(256, generator=gen)[:60]] *= 1.01  # under a quarter
    assert compare_lm.token_gap(flipped, ref) == pytest.approx(floor, rel=0.5)
    assert compare_lm.token_gap(ref * (1 + 1e-4 * noise), ref) > 100 * floor
    with pytest.raises(ValueError):
        compare_lm.token_gap(program[:, 1:], ref)


def test_the_tf32_control_fails_the_cell_by_its_token_gap(tiny):
    """Every product in TF32 (the reference's control) against the float32
    reference: its token gap passes the cell's limit, the program's stays
    under it."""
    config, traffic = tiny
    limit = Spec().cell(CELL)["limits"]["token_loss_gap"]
    weights = lm_train.draw_weights(config, SEED, "cpu")
    ids = lm_train.draw_batches(config, traffic, SEED, "cpu", 1)[0]
    ref = reference.token_losses(config, weights, ids, rows=16)
    control = reference.token_losses(config, weights, ids, tf32=True, rows=16)
    mine = lm.token_losses(_mesh(), lm.LMConfig.from_dict(config), weights, ids)
    assert compare_lm.token_gap(control, ref) > limit > compare_lm.token_gap(mine, ref)


def test_planted_faults_leave_with_their_block(tiny):
    config, _ = tiny
    before = lm.LMConfig.from_dict(config)
    with faults_lm.planted("top7"):
        assert lm.LMConfig.from_dict(config).top_k == before.top_k - 1
    assert lm.LMConfig.from_dict(config) == dataclasses.replace(before)


def test_train_check_runs_the_model_by_name(monkeypatch):
    """The perf pod's ``train`` check takes ``TRAIN_MODEL``: the model's step
    at tiny widths on the CPU, its model FLOPs from the same shapes as the
    benchmark's count."""
    from tpu_operator_torch.workloads import train_bench

    monkeypatch.setenv(train_bench.MODEL_ENV, "k-exaone-236b-a23b-ep16")
    r = train_bench.quick_check(device="cpu")
    assert r["ok"] and r["model"] == "k-exaone-236b-a23b-ep16" and r["seq"] == 32
    config = dict(lm.MODELS["k-exaone-236b-a23b-ep16"], **train_bench.CPU_WIDTHS)
    want = counts_lm.step_model_flops(config, 2, 32)
    assert train_bench.lm_model_flops(lm.LMConfig.from_dict(config), 2, 32) == \
        pytest.approx(want, rel=1e-12)
    monkeypatch.delenv(train_bench.MODEL_ENV)
    assert train_bench.quick_check(device="cpu")["model"] == "transformer-layer"


def _mesh_rank(rank, n, device, config, traffic, shape):
    """One rank of ``shape`` (dp, mp): its rows and sequence shard (and the
    next shard's first token) of the batch, one step; the loss and each
    leaf's update norm."""
    mesh = collectives.make_mesh(n, rank, device, shape=tuple(shape))
    weights = lm_train.draw_weights(config, SEED, device)
    ids = lm_train.draw_batches(config, traffic, SEED, device, 1)[0]
    b, s = ids.shape[0] // mesh.dp, (ids.shape[1] - 1) // mesh.mp
    i, j = mesh.coords
    mine = ids[i * b:(i + 1) * b, j * s:(j + 1) * s + 1].contiguous()
    loss, new = lm.train_step(mesh, lm.LMConfig.from_dict(config), weights, mine, config["lr"])
    return {"loss": float(loss),
            "update": {k: float((weights[k] - new[k]).double().norm()) for k in weights}}


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["mp2", "dp2"])
def test_train_step_over_two_ranks_is_the_one_rank_step(tiny, shape):
    """On two gloo ranks, the sequence split over mp (the window across the
    ring's hops, rotary positions from the rank's offset, the label of a
    shard's last token from the next shard) or the batch over dp: the loss
    and every leaf's update are the one-rank step's."""
    from tpu_operator_torch.workloads import _ranks

    config, traffic = tiny
    one = _mesh_rank(0, 1, torch.device("cpu"), config, traffic, (1, 1))
    two = _ranks.run(_mesh_rank, 2, "cpu", config=config, traffic=traffic, shape=list(shape))
    assert math.isclose(two["loss"], one["loss"], rel_tol=LOSS_RTOL)
    for name, norm in one["update"].items():
        assert math.isclose(two["update"][name], norm, rel_tol=CHANGE_RTOL), name


def test_the_roofline_reader_finds_the_windowed_kernels():
    """The sliding layers' hops launch kernels of their own
    (``fold_band_kernel``, ``dkdv_band_kernel``, ``dq_band_kernel``, so the
    causal kernels stay as they were): the language model's readers
    (``readings_lm``) read them and the causal f32 ones, and no bf16
    kernel."""
    import os
    import re

    from benchmark import readings_lm

    source = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tpu_operator_torch", "csrc", "flash_backward.cu")
    with open(source) as f:
        text = f.read()
    for kernel, pattern in (("fold_band_kernel", readings_lm.B3_F32),
                            ("dkdv_band_kernel", readings_lm.B4_F32[0]),
                            ("dq_band_kernel", readings_lm.B4_F32[1])):
        assert re.search(r"\b" + kernel + r"<DP><<<", text), kernel
        assert re.search(pattern, f"void (anonymous namespace)::{kernel}<128>(x)")
    assert re.search(readings_lm.B3_F32, "fold_f32_kernel<128>")
    assert re.search(readings_lm.B4_F32[0], "dkdv_kernel<float, 128>")
    assert not re.search(readings_lm.B4_F32[1], "dq_kernel<__nv_bfloat16, 128>")


LM_TRACE_READERS = ("lm.attn_kernels_roofline", "lm.b3_f32_roofline", "lm.b4_f32_roofline",
                    "lm.attn_kernels.device_share")


def _lm_trace_ctx(launches: int = 2 * 5) -> dict:
    """A traced window of 2 steps of the five-layer model: B3 f32 and B4 f32
    launched once a layer a step, 100 ms each kind, in 1 s of device time."""
    ops = {"void fold_band_kernel<128>(x)": [0.08, launches - 2],
           "void fold_f32_kernel<128>(x)": [0.02, 2],
           "void dkdv_band_kernel<128>(x)": [0.08, launches - 2],
           "void dkdv_kernel<float, 128>(x)": [0.02, 2],
           "void dq_band_kernel<128>(x)": [0.08, launches - 2],
           "void dq_kernel<float, 128>(x)": [0.02, 2],
           "sm90_xmmaGemm_f32": [0.7, 400]}
    return {"trace": [{"device_s": 1.0, "ops": ops}], "traced_steps": 2,
            "device_kind": "NVIDIA H100 80GB HBM3",
            "lm": {"batch": 4, "heads": 64, "seq": 4096, "d_head": 128,
                   "windows": [128, 128, 128, 0, 128]}}


@pytest.mark.parametrize("metric", LM_TRACE_READERS)
def test_the_attention_readers_read_both_kernels_and_need_each_layer(metric):
    """Each attention reader of the language model gives a share in (0,
    100] when both kernels launched once a layer a step, and None when a
    launch is missing or the run carries no model (the probe's cells)."""
    read = Spec().reader(metric)
    value = read(_lm_trace_ctx())
    assert value is not None and 0 < value <= 100
    if metric.endswith("device_share"):
        assert value == pytest.approx(30.0)
    else:
        assert read(_lm_trace_ctx(launches=9)) is None
    assert read({**_lm_trace_ctx(), "lm": None}) is None


def test_the_two_kernels_shares_make_up_the_joint_one():
    """``lm.attn_kernels_roofline`` is the time-weighted mean of the B3 and
    B4 shares: the joint least time over the joint device time."""
    spec, ctx = Spec(), _lm_trace_ctx()
    b3, b4, both = (spec.reader(m)(ctx) for m in ("lm.b3_f32_roofline", "lm.b4_f32_roofline",
                                                   "lm.attn_kernels_roofline"))
    # B3 took 100 ms and B4 200 ms of device time
    assert both == pytest.approx((b3 * 0.1 + b4 * 0.2) / 0.3)
