"""Parity of the port's serving engine (``tpu_operator_torch.workloads.
serving``) and of kernel B5's f32 entry with the JAX reference, on the CPU.

The same seeds and numpy inputs go through both packages: the toy model's
weights, the paged KV cache's operations, whole engine runs (token streams
compared request by request, in the dense attend and in the flash attend,
whose reference runs the Pallas kernel in interpret mode), snapshots
restored across the packages, the traffic generator and the replica loop.

Token streams come from an argmax over logits, so two correct engines can
part only where a step's top two logits nearly tie.  Each stream comparison
replays the streams in float64 and reports the smallest top-2 logit gap it
saw; where a stream differs, the failure names the seed, the request, the
token and its gap.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator.obs import flight as jflight  # noqa: E402
from tpu_operator.workloads import checkpoint as jckpt  # noqa: E402
from tpu_operator.workloads import longctx as jlc  # noqa: E402
from tpu_operator.workloads import serving as jsrv  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.obs import flight as tflight  # noqa: E402
from tpu_operator_torch.workloads import checkpoint as tckpt  # noqa: E402
from tpu_operator_torch.workloads import serving as tsrv  # noqa: E402

FLASH_OUT_RTOL = 1e-5  # f32 out vs Pallas: of max |ref|
FLASH_LSE_RTOL = 1e-6  # f32 lse, relative


def _tiny(pkg, **over):
    """The reference tests' tiny engine config (``test_serving.py:20``)."""
    base = dict(heads=2, head_dim=8, num_blocks=32, block_tokens=8,
                max_batch=4, max_context=64, prefill_budget=16)
    base.update(over)
    if pkg is tsrv:
        base.setdefault("device", "cpu")
    return pkg.ServeConfig(**base)


def _req(pkg, rid, prompt_len=12, new=6, seed=0, arrival=0.0, vocab=128):
    rng = np.random.default_rng(seed)
    return pkg.Request(rid=rid, prompt=[int(t) for t in rng.integers(0, vocab, prompt_len)],
                       max_new_tokens=new, arrival=arrival)


def _min_gap(model, streams: dict, prompts: dict) -> tuple:
    """Replay every stream in float64 (exact causal attention over the whole
    context, the model's numpy weights) and return (smallest top-2 logit gap
    over all generated tokens, {rid: [gap per token]})."""
    d = model.heads * model.head_dim
    w = {n: np.asarray(getattr(model, n), np.float64) for n in ("emb", "pos", "wq", "wk", "wv",
                                                                "wu")}
    gaps = {}
    for rid, gen in streams.items():
        tokens = list(prompts[rid]) + list(gen)
        x = w["emb"][tokens] + w["pos"][np.arange(len(tokens))]
        q, k, v = (x @ w[n] for n in ("wq", "wk", "wv"))
        shape = (len(tokens), model.heads, model.head_dim)
        q, k, v = (a.reshape(shape) for a in (q, k, v))
        row = []
        for t in range(len(prompts[rid]), len(tokens)):
            s = np.einsum("hd,chd->hc", q[t - 1], k[:t]) / np.sqrt(model.head_dim)
            p = np.exp(s - s.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            logits = np.einsum("hc,chd->hd", p, v[:t]).reshape(d) @ w["wu"]
            top = np.sort(logits)[-2:]
            row.append(float(top[1] - top[0]))
        gaps[rid] = row
    return min(g for row in gaps.values() for g in row), gaps


def _assert_same_streams(mine: dict, ref: dict, model, prompts: dict, seed) -> float:
    gap, gaps = _min_gap(model, ref, prompts)
    for rid in ref:
        a, b = list(mine[rid]), list(ref[rid])
        if a != b:
            i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            pytest.fail(f"seed {seed}: request {rid} differs at token {i}: port {a}, "
                        f"reference {b}; top-2 logit gap there "
                        f"{gaps[rid][i] if i < len(gaps[rid]) else 'n/a'}")
    print(f"seed {seed}: {len(ref)} streams identical, smallest top-2 logit gap {gap:.3e}")
    return gap


def _drive(engine, reqs, max_steps=200):
    for req in reqs:
        assert engine.submit(req)
    for i in range(max_steps):
        if not engine.active:
            break
        engine.step(float(i))
    return {r.rid: list(r.tokens[len(r.prompt):]) for r in reqs}


# ---------------------------------------------------------------------------
# the model and the cache


def test_toylm_weights_equal_reference_bit_for_bit():
    ref = jsrv.ToyLM(vocab=128, heads=2, head_dim=16, max_context=128, seed=3)
    mine = tsrv.ToyLM(vocab=128, heads=2, head_dim=16, max_context=128, seed=3, device="cpu")
    carried = tsrv.toylm_from_numpy(ref, device="cpu")
    for name in tsrv.ToyLM.WEIGHTS:
        want = np.asarray(getattr(ref, name))
        for model in (mine, carried):
            got = getattr(model, name)
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == want.tobytes(), name
    toks, pos = [5, 9, 127, 0], [0, 1, 2, 70]
    for a, b in zip(mine.qkv(toks, pos, rows=16), ref.qkv(np.asarray(toks), np.asarray(pos))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)


def _cache_alloc_free(pkg):
    cache = pkg.PagedKVCache(8, 4, 2, 8, **({"device": "cpu"} if pkg is tsrv else {}))
    out = [cache.try_alloc(3), cache.try_alloc(5), cache.try_alloc(1), cache.alloc_failures]
    cache.free(out[0])
    out.append(cache.free_count)
    with pytest.raises(pkg.ServingError):
        cache.free([0])  # double-free is loud
    out.append(cache.try_alloc(2))
    return out


def _cache_roundtrip(pkg):
    cache = pkg.PagedKVCache(8, 4, 2, 8, **({"device": "cpu"} if pkg is tsrv else {}))
    burn = cache.try_alloc(3)
    table = cache.try_alloc(3)  # blocks 3, 4, 5: non-contiguous after the free
    cache.free(burn)
    rng = np.random.default_rng(1)
    k = rng.standard_normal((10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((10, 2, 8)).astype(np.float32)
    conv = torch.from_numpy if pkg is tsrv else (lambda a: a)
    cache.write_tokens(table, 0, conv(k[:6]), conv(v[:6]))
    cache.write_tokens(table, 6, conv(k[6:]), conv(v[6:]))  # across a block seam
    gk, gv = cache.gather(table, 10, pad_to=16)
    gk, gv = np.asarray(gk), np.asarray(gv)
    np.testing.assert_array_equal(gk[:10], k)
    np.testing.assert_array_equal(gv[:10], v)
    assert not gk[10:].any() and not gv[10:].any()
    return [table, gk.tobytes(), gv.tobytes(), np.asarray(cache.k).tobytes()]


def _cache_integrity(pkg):
    cache = pkg.PagedKVCache(8, 4, 2, 8, **({"device": "cpu"} if pkg is tsrv else {}))
    t1, t2 = cache.try_alloc(2), cache.try_alloc(2)
    cache.check_integrity({"a": t1, "b": t2})
    with pytest.raises(pkg.ServingError):
        cache.check_integrity({"a": t1, "b": [t1[0]] + t2[1:]})
    cache.free(t2)
    with pytest.raises(pkg.ServingError):
        cache.check_integrity({"a": t1, "b": t2})  # owned and on the free list
    return [t1, t2, cache.free_count]


def _cache_defrag(pkg):
    cache = pkg.PagedKVCache(16, 4, 2, 8, **({"device": "cpu"} if pkg is tsrv else {}))
    low = cache.try_alloc(6)
    high = cache.try_alloc(4)  # blocks 6..9
    cache.k[high] = 7.0
    cache.v[high] = 9.0
    cache.free(low)
    before = cache.high_water()
    tables = {"r": list(high)}
    moves = cache.defrag(tables)
    assert (cache.k[tables["r"]] == 7.0).all() and (cache.v[tables["r"]] == 9.0).all()
    cache.check_integrity(tables)
    return [before, moves, cache.high_water(), tables["r"]]


@pytest.mark.parametrize("case", [_cache_alloc_free, _cache_roundtrip, _cache_integrity,
                                  _cache_defrag], ids=lambda f: f.__name__[7:])
def test_paged_cache_matches_reference(case):
    """Allocation and double-free, the paged write/gather round trip across a
    block seam, the integrity checks and defrag: the same operations give
    the same tables, counts and bytes in both packages."""
    assert case(tsrv) == case(jsrv)


# ---------------------------------------------------------------------------
# kernel B5's f32 entry


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("length", [24, 40, 136])
def test_flash_f32_matches_pallas_at_serving_shapes(length, d, causal):
    """The engine's flash attend: BH 2 (the heads), an 8-row query tail at
    q_off = length - 8, keys zero-padded to a 16-token page.  f32 in gives
    f32 out, as the reference's dtype-generic kernel does."""
    rng = np.random.default_rng(length * 100 + d)
    pad = 16 * -(-length // 16)
    q = rng.standard_normal((2, 8, d)).astype(np.float32)
    k = np.zeros((2, pad, d), np.float32)
    v = np.zeros((2, pad, d), np.float32)
    k[:, :length] = rng.standard_normal((2, length, d))
    v[:, :length] = rng.standard_normal((2, length, d))
    kw = dict(causal=causal, block_k=16, block_q=8, q_off=length - 8)
    out, lse = fa.flash_attention_local(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    ref, ref_lse = (np.asarray(a) for a in jlc.flash_attention_local(q, k, v, **kw))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(out.numpy() - ref).max() <= FLASH_OUT_RTOL * np.abs(ref).max()
    assert (np.abs(lse.numpy() - ref_lse) / np.abs(ref_lse)).max() <= FLASH_LSE_RTOL


def test_flash_f32_row_with_no_key_is_exact():
    """A row that sees no key: out exactly 0 and lse exactly -1e30."""
    q, k, v = (torch.randn(2, 8, 16) for _ in range(3))
    out, lse = fa.flash_attention_local(q, k, v, True, 16, 8, q_off=0, k_off=100)
    assert not out.any() and bool((lse == fa.NEG_INF).all())


# ---------------------------------------------------------------------------
# engine runs against the JAX engine


@pytest.mark.parametrize("attend", ["dense", "flash"])
def test_quick_check_request_set_streams_match_jax(attend):
    """``quick_check``'s request set (seed 7: 8 requests, 24 prompt and 12
    new tokens, max_batch 8) through one batched run of each engine."""
    rng_reqs = {}

    def reqs(pkg):
        rng = np.random.default_rng(7)
        out = [pkg.Request(rid=f"ab-{i}", prompt=[int(t) for t in rng.integers(0, 128, 24)],
                           max_new_tokens=12, arrival=0.0) for i in range(8)]
        rng_reqs.update({r.rid: r.prompt for r in out})
        return out

    mine = _drive(tsrv.ServingEngine(tsrv.ServeConfig(max_batch=8, attend=attend,
                                                      device="cpu")), reqs(tsrv))
    ref_engine = jsrv.ServingEngine(jsrv.ServeConfig(max_batch=8, attend=attend))
    ref = _drive(ref_engine, reqs(jsrv))
    assert all(len(s) == 12 for s in ref.values())
    _assert_same_streams(mine, ref, ref_engine.model, rng_reqs, seed=7)


def test_flash_and_dense_streams_match_jax():
    """The reference's flash-vs-dense case (``test_serving.py:153-169``):
    two requests, max_batch 2, in both attends and both packages."""
    streams = {}
    for pkg in (tsrv, jsrv):
        for attend in ("dense", "flash"):
            engine = pkg.ServingEngine(_tiny(pkg, max_batch=2, attend=attend))
            reqs = [_req(pkg, "r0", 12, 5, seed=5), _req(pkg, "r1", 9, 5, seed=6)]
            streams[pkg.__name__, attend] = _drive(engine, reqs, 40)
    prompts = {r.rid: r.prompt for r in (_req(jsrv, "r0", 12, 5, seed=5),
                                         _req(jsrv, "r1", 9, 5, seed=6))}
    ref = streams[jsrv.__name__, "dense"]
    model = jsrv.ToyLM(heads=2, head_dim=8, max_context=64)
    for key, got in streams.items():
        _assert_same_streams(got, ref, model, prompts, seed=f"5/6 {key}")


@pytest.mark.parametrize("prompts", [(24,) * 8, (3, 12, 5, 20)], ids=["quick-check", "short-tails"])
def test_flash_step_is_one_paged_call_and_no_gather(monkeypatch, prompts):
    """The flash attend makes one ``flash_attention_paged`` call per decode
    step that has a context at or past the 8-row tail, none in a step that
    has only shorter ones, and gathers pages only for the dense attend of a
    context shorter than the tail (one gather each)."""
    paged, gathers, steps = [], [0], []
    call, gather, attend = (fa.flash_attention_paged, tsrv.PagedKVCache.gather,
                            tsrv.ServingEngine._attend_flash)

    def counted_call(*args):
        paged.append(int((args[4] > 0).sum()))
        return call(*args)

    def counted_gather(self, *args, **kwargs):
        gathers[0] += 1
        return gather(self, *args, **kwargs)

    def counted_attend(self, reqs, qs):
        steps.append(sum(len(req.tokens) >= tsrv.FLASH_TAIL for req in reqs))
        return attend(self, reqs, qs)

    monkeypatch.setattr(fa, "flash_attention_paged", counted_call)
    monkeypatch.setattr(tsrv.PagedKVCache, "gather", counted_gather)
    monkeypatch.setattr(tsrv.ServingEngine, "_attend_flash", counted_attend)
    engine = tsrv.ServingEngine(tsrv.ServeConfig(max_batch=8, attend="flash", device="cpu"))
    streams = _drive(engine, [_req(tsrv, f"p{i}", n, 12, seed=i) for i, n in enumerate(prompts)])
    assert all(len(s) == 12 for s in streams.values())
    assert len(paged) == sum(1 for n in steps if n) > 0
    assert paged == [n for n in steps if n]  # every long-enough context in the one call
    assert gathers[0] == engine.dense_tail_attends == sum(max(0, 8 - n) for n in prompts)


def test_flash_streams_match_jax_after_defrag():
    """A mid-run ``defrag`` moves live pages to lower blocks and rewrites the
    block tables; the flash attend then reads the moved pages in place and
    both engines, defragmented at the same step, give the same streams."""
    streams, moves = {}, {}
    for pkg in (tsrv, jsrv):
        engine = pkg.ServingEngine(_tiny(pkg, attend="flash", num_blocks=32))
        reqs = [_req(pkg, "r0", 9, 2, seed=0), _req(pkg, "r1", 10, 3, seed=1),
                _req(pkg, "r2", 14, 12, seed=2), _req(pkg, "r3", 12, 16, seed=3)]
        for req in reqs:
            assert engine.submit(req)
        for i in range(60):
            if i == 5:
                before = {rid: list(t) for rid, t in engine.block_tables().items()}
                moves[pkg.__name__] = engine.cache.defrag(engine.block_tables())
                assert engine.block_tables() != before
                engine.check_integrity()
            if not engine.active:
                break
            engine.step(float(i))
        streams[pkg.__name__] = {r.rid: list(r.tokens[len(r.prompt):]) for r in reqs}
        prompts = {r.rid: r.prompt for r in reqs}
    assert moves[tsrv.__name__] == moves[jsrv.__name__] > 0
    _assert_same_streams(streams[tsrv.__name__], streams[jsrv.__name__],
                         jsrv.ToyLM(heads=2, head_dim=8, max_context=64), prompts, "defrag")


def test_batching_ab_matches_jax():
    """``test_serving.py:172-184``: identical outputs at admission width 1
    and max_batch, and more than twice the steps sequentially; the port's
    streams equal the JAX engine's."""
    mine_streams = {}
    mine = tsrv.batching_ab(n_requests=6, prompt_tokens=16, new_tokens=8,
                            cfg=tsrv.ServeConfig(device="cpu"), streams=mine_streams)
    ref = jsrv.batching_ab(n_requests=6, prompt_tokens=16, new_tokens=8)
    assert mine["identical_outputs"] and mine["ok"] and ref["ok"]
    assert mine["sequential"]["steps"] > mine["batched"]["steps"] * 2
    for run in ("sequential", "batched"):
        for key in ("tokens", "completed", "steps"):
            assert mine[run][key] == ref[run][key], (run, key)
    rng = np.random.default_rng(7)
    prompts = {f"ab-{i}": [int(t) for t in rng.integers(0, 128, 16)] for i in range(6)}
    ref_streams = _drive(jsrv.ServingEngine(jsrv.ServeConfig()),
                         [jsrv.Request(rid=r, prompt=p, max_new_tokens=8, arrival=0.0)
                          for r, p in prompts.items()])
    _assert_same_streams(mine_streams, ref_streams, jsrv.ToyLM(max_context=128), prompts, 7)


def _scheduling_trace(pkg, case):
    if case == "admission":
        engine = pkg.ServingEngine(_tiny(pkg, num_blocks=4, block_tokens=8, max_batch=4,
                                         max_context=16, prefill_budget=64))
        reqs = [_req(pkg, f"a{i}", 8, 4, seed=i) for i in range(2)] + [_req(pkg, "b0", 8, 4, 9)]
    elif case == "chunked-prefill":
        engine = pkg.ServingEngine(_tiny(pkg, num_blocks=32, prefill_budget=8))
        reqs = [_req(pkg, "short", 8, 20, seed=1), _req(pkg, "long", 40, 4, seed=2)]
    else:  # cancel
        engine = pkg.ServingEngine(_tiny(pkg))
        reqs = [_req(pkg, "c0", 16, 8), _req(pkg, "c1", 10, 6, seed=3)]
    trace = []
    for req in reqs[:1 if case == "chunked-prefill" else len(reqs)]:
        engine.submit(req)
    for i in range(40):
        if case == "chunked-prefill" and i == 3:
            engine.submit(reqs[1])
        if case == "cancel" and i == 2:
            trace.append(engine.cancel("c0"))
        stats = engine.step(float(i))
        trace.append((stats["admitted"], stats["prefill_completed"], stats["finished"],
                      stats["queue_depth"], stats["batch"], stats["prefilling"],
                      stats["kv_blocks_free"], [r.state for r in reqs]))
        engine.check_integrity()
        if not engine.active:
            break
    return trace, {r.rid: r.tokens for r in reqs}, engine.requests_completed


@pytest.mark.parametrize("case", ["admission", "chunked-prefill", "cancel"])
def test_scheduling_matches_jax(case):
    """Capacity-based FIFO admission, chunked prefill beside a decoding
    request, and a cancel: step by step the same counts, states and
    tokens as the JAX engine."""
    assert _scheduling_trace(tsrv, case) == _scheduling_trace(jsrv, case)


def test_oversize_request_rejected_and_counted():
    engine = tsrv.ServingEngine(_tiny(tsrv, max_context=32))
    assert not engine.submit(_req(tsrv, "big", 30, 10))
    assert not engine.submit(tsrv.Request(rid="empty", prompt=[], max_new_tokens=1, arrival=0.0))
    assert engine.requests_rejected == 2
    small = tsrv.ServingEngine(_tiny(tsrv, num_blocks=2, block_tokens=8, max_context=64))
    assert not small.submit(_req(tsrv, "wedge", 24, 8))  # over the whole pool
    assert small.submit(_req(tsrv, "fits", 8, 4))
    _drive(small, [], 20)
    assert small.requests_completed == 1


# ---------------------------------------------------------------------------
# snapshots across the packages


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_snapshot_restores_across_packages(tmp_path, direction):
    """An engine interrupted mid-flight in one package, snapshotted through
    its checkpoint module and restored by the other package, continues with
    the tokens of an uninterrupted run."""
    src, dst = (jsrv, tsrv) if direction == "jax-to-torch" else (tsrv, jsrv)
    src_ckpt, dst_ckpt = (jckpt, tckpt) if src is jsrv else (tckpt, jckpt)

    def fresh(pkg):
        engine = pkg.ServingEngine(_tiny(pkg, num_blocks=32))
        reqs = [_req(pkg, f"r{i}", 10 + i, 8, seed=i) for i in range(4)]
        for req in reqs:
            engine.submit(req)
        return engine

    reference = fresh(jsrv)
    for i in range(30):
        reference.step(float(i))
    engine = fresh(src)
    for i in range(7):
        engine.step(float(i))
    arrays, extra = engine.snapshot()
    src_ckpt.save_checkpoint(str(tmp_path), step=engine.steps, arrays=arrays, extra=extra)
    snap = dst_ckpt.load_checkpoint(str(tmp_path))
    restored = dst.ServingEngine.from_snapshot(_tiny(dst, num_blocks=32), snap.arrays, snap.extra)
    restored.check_integrity()
    assert np.asarray(restored.cache.k).tobytes() == np.asarray(engine.cache.k).tobytes()
    for i in range(7, 30):
        restored.step(float(i))
    assert restored.tokens_generated == reference.tokens_generated
    assert restored.requests_completed == reference.requests_completed
    assert (sorted((c["rid"], c["tokens"]) for c in restored.completions())
            == sorted((c["rid"], c["tokens"]) for c in reference.completions()))


def test_snapshot_rejects_mismatched_config():
    arrays, extra = tsrv.ServingEngine(_tiny(tsrv)).snapshot()
    with pytest.raises(tsrv.ServingError):
        tsrv.ServingEngine.from_snapshot(_tiny(tsrv, num_blocks=16), arrays, extra)


def test_poisson_traffic_matches_and_round_trips():
    """The same seed mints the same schedule in both packages, and a state
    taken from either continues the schedule in the other."""
    mine, ref = tsrv.PoissonTraffic(rate=50.0, seed=11), jsrv.PoissonTraffic(rate=50.0, seed=11)
    a, b = mine.due(1.0), ref.due(1.0)
    assert a and [(r.rid, r.prompt, r.arrival, r.max_new_tokens) for r in a] == \
        [(r.rid, r.prompt, r.arrival, r.max_new_tokens) for r in b]
    for src, dst_pkg in ((mine, jsrv), (ref, tsrv)):
        state = src.state()
        cont = src.due(2.0)
        other = dst_pkg.PoissonTraffic(rate=50.0, seed=999)  # wrong seed on purpose
        other.restore(state)
        resumed = other.due(2.0)
        assert [(r.rid, r.prompt, r.arrival) for r in cont] == \
            [(r.rid, r.prompt, r.arrival) for r in resumed]


# ---------------------------------------------------------------------------
# the replica loop, the check, telemetry


class _Sig:
    def __init__(self):
        self.fire = False

    def requested(self):
        return self.fire


def test_serve_loop_checkpoints_on_migrate_signal(tmp_path, monkeypatch):
    """serve -> the migrate signal lands -> final checkpoint and exit; a
    second serve() restores and serves the remainder with the token
    counter and the traffic schedule intact."""
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(tmp_path / "vroot"))
    cfg = _tiny(tsrv, num_blocks=32)
    ckpt_dir = str(tmp_path / "serve-ckpt")
    os.makedirs(ckpt_dir)
    events, sig, clock = [], _Sig(), {"t": 0.0}

    def fake_clock():
        clock["t"] += 0.02
        if clock["t"] > 1.0:
            sig.fire = True
        return clock["t"]

    traffic = tsrv.PoissonTraffic(rate=40.0, prompt_tokens=(8, 12), new_tokens=(4, 8), seed=3)
    first = tsrv.serve(cfg, traffic, duration_s=30.0, ckpt_dir=ckpt_dir, sig=sig,
                       progress=events.append, step_interval_s=0.0, clock=fake_clock)
    assert first["ok"] and first["migrated_out"] and first["checkpointed"]
    assert first["tokens_total"] > 0
    done = [e for e in events if e["event"] == "checkpointed"]
    assert done and done[0]["trigger"] == "migrate-signal" and done[0]["in_flight"] > 0
    # the snapshot is the reference's format: its own loader reads it
    assert jckpt.load_checkpoint(ckpt_dir).extra["serve"]["traffic"]["next_id"] == traffic.next_id

    clock2, events2 = {"t": 0.0}, []

    def clock_2():
        clock2["t"] += 0.02
        return clock2["t"]

    traffic2 = tsrv.PoissonTraffic(rate=40.0, prompt_tokens=(8, 12), new_tokens=(4, 8), seed=3)
    second = tsrv.serve(cfg, traffic2, duration_s=first["elapsed_s"] + 1.5, ckpt_dir=ckpt_dir,
                        sig=_Sig(), progress=events2.append, step_interval_s=0.0, clock=clock_2)
    assert second["ok"] and second["resumed"] and not second["migrated_out"]
    assert events2[0]["event"] == "restored" and events2[0]["resumed_requests"] > 0
    assert second["tokens_total"] >= first["tokens_total"]
    assert traffic2.next_id >= traffic.next_id
    assert second["in_flight_at_exit"] == 0


def test_serve_loop_idle_reports_zero_rate(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_VALIDATION_ROOT", str(tmp_path / "vroot"))
    clock = {"t": 0.0}

    def fake_clock():
        clock["t"] += 0.05
        return clock["t"]

    events = []
    result = tsrv.serve(_tiny(tsrv), tsrv.PoissonTraffic(rate=0.0, seed=1), duration_s=2.5,
                        progress=events.append, step_interval_s=0.0, clock=fake_clock)
    assert result["ok"] and result["tokens_total"] == 0
    reports = [e for e in events if e["event"] == "serving"]
    assert reports and all(r["tokens_per_sec"] == 0.0 for r in reports)


def test_quick_check_passes_and_counts_the_dense_tail():
    result = tsrv.quick_check(device="cpu")
    assert result["ok"] and result["identical_outputs"] and result["check"] == "serving"
    assert result["batched"]["completed"] == 8 and result["backend"] == "cpu"
    # a context shorter than the 8-row tail takes the dense attend, counted
    engine = tsrv.ServingEngine(_tiny(tsrv, attend="flash"))
    _drive(engine, [_req(tsrv, "s", 3, 6)], 20)
    assert engine.dense_tail_attends == 5  # contexts 3..7


def test_telemetry_keys_ride_the_reference_catalogue():
    """Every telemetry key the port's engine emits maps, in the port's flight
    catalogue, onto the same ``tpu_workload_serving_*`` counter as in the
    reference's."""
    engine = tsrv.ServingEngine(_tiny(tsrv))
    _drive(engine, [_req(tsrv, "t0", 8, 3)], 10)
    telemetry = engine.telemetry(10.0)
    assert "serve_decoded_tokens" in telemetry
    for key in telemetry:
        assert tflight.COUNTER_KEYS[key] == jflight.COUNTER_KEYS[key]
        assert tflight.COUNTER_KEYS[key].startswith("tpu_workload_serving_")
    for key in ("checkpoint_s", "restore_s", "acct_useful_s", "acct_wasted_s",
                "replayed_steps", "lost_steps"):
        assert tflight.COUNTER_KEYS[key] == jflight.COUNTER_KEYS[key]
