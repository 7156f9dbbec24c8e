"""Parity of the port's ring attention (``tpu_operator_torch.workloads.
ring_attention``) and of the flash block update (kernel B3's plain version)
with the JAX reference, on identical inputs, on the CPU.

Inputs are made with numpy from a seed, rounded to bf16 once, and handed to
both sides.  The reference's Pallas kernel runs in interpret mode, as the
reference's own tests run it here.  The four-rank cases run four gloo ranks
against a four-device JAX mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from tpu_operator.workloads import ring_attention as jra  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.workloads import ring_attention as tra  # noqa: E402

OUT_TOL = 2e-2     # bf16 outputs
STATE_RTOL = 1e-3  # f32 state, sums in another order


def _bf16(rng, shape):
    """(numpy f32 of bf16 values, torch bf16, jax bf16): one draw, one
    rounding, the same values on both sides."""
    t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
    x = t.float().numpy()
    return x, t, jnp.asarray(x, jnp.bfloat16)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal, k_base", [(True, 32), (False, 32), (True, 1000)],
                         ids=["causal-partial", "full", "causal-fully-masked"])
def test_online_softmax_block_update_matches_jnp(causal, k_base, storage):
    """The shared tile update against the reference's own function: the
    same formula, so 1e-5 covers summation order only.  With bf16 q/k/v the
    PV product takes e rounded to bf16, which an f32 e would miss by far
    more than 1e-5.  Half the rows start from the empty state (m = NEG_INF,
    l = 0)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in ((16, 8), (24, 8), (24, 8)))
    if storage == "bfloat16":  # bf16 values, held in f32 until each side casts
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    m = rng.standard_normal((16, 1), dtype=np.float32)
    m[::2] = jra.NEG_INF
    l = np.where(m > jra.NEG_INF, rng.uniform(1, 3, (16, 1)), 0).astype(np.float32)
    acc = rng.standard_normal((16, 8), dtype=np.float32) * (l > 0)
    scale = 1.0 / np.sqrt(8)
    jq, jk, jv = (jnp.asarray(x, storage) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, storage)) for x in (q, k, v))
    ref = jra.online_softmax_block_update(causal, scale, jq, jk, jv,
                                          *map(jnp.asarray, (m, l, acc)), 40, k_base)
    mine = fa.online_softmax_block_update(causal, scale, tq, tk, tv,
                                          *map(torch.from_numpy, (m, l, acc)), 40, k_base)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _state(rng, bh, t, d):
    """A carried (m, l, o) state: one earlier, fully visible block folded
    in by the reference."""
    _, _, q = _bf16(rng, (bh, t, d))
    _, _, k = _bf16(rng, (bh, t, d))
    _, _, v = _bf16(rng, (bh, t, d))
    m0 = jnp.full((bh, t), jra.NEG_INF, jnp.float32)
    l0 = jnp.zeros((bh, t), jnp.float32)
    o0 = jnp.zeros((bh, t, d), jnp.float32)
    return jra.flash_block_update(q, k, v, 64, 0, m0, l0, o0, True)


@pytest.mark.parametrize(
    "q_off, k_off, causal",
    [(64, 48, True), (64, 64, True), (64, 200, False), (64, 64 + 32 + 8, True)],
    ids=["causal-offsets", "diagonal", "non-causal", "fully-masked"],
)
def test_flash_block_update_matches_pallas(q_off, k_off, causal):
    """One block folded into a carried state: the port (plain B3 on the
    CPU, in place) against the reference's Pallas kernel.  A fully masked
    block (k_off > q_off + Tq) must leave the state exactly as it was."""
    bh, t, d = 4, 32, 8
    rng = np.random.default_rng(1)
    m, l, o = _state(rng, bh, t, d)
    _, tq, jq = _bf16(rng, (bh, t, d))
    _, tk, jk = _bf16(rng, (bh, t, d))
    _, tv, jv = _bf16(rng, (bh, t, d))
    ref = jra.flash_block_update(jq, jk, jv, q_off, k_off, m, l, o, causal)
    state = tuple(torch.from_numpy(np.array(x)) for x in (m, l, o))
    mine = tra.flash_block_update(tq, tk, tv, q_off, k_off, *state, causal)
    assert all(a is b for a, b in zip(mine, state))  # updated in place
    if causal and k_off > q_off + t:
        for a, b in zip(mine, (m, l, o)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    rm, rl, ro = (np.asarray(x) for x in ref)
    mm, ml, mo = (x.numpy() for x in mine)
    assert _rel(mm, rm) <= STATE_RTOL and _rel(ml, rl) <= STATE_RTOL
    out, ref_out = mo / ml[..., None], ro / rl[..., None]
    assert np.max(np.abs(out - ref_out)) <= OUT_TOL


# label: bh, tq, tk, q_off, k_off, causal.  Key tiles of 64, q tiles of 16:
# 320 keys are 5 tiles, so some warps fold two and some q tiles fewer than
# four; 40 x 72 leaves warps with no tile
SPLIT_CASES = {
    "diagonal": (2, 320, 320, 320, 320, True),
    "offsets": (2, 48, 320, 300, 0, True),
    "non-causal": (2, 48, 320, 0, 500, False),
    "fully-masked": (2, 48, 320, 0, 100, True),
    "ragged-40x72": (3, 40, 72, 64, 48, True),
    "ragged-some-q-tiles-see-no-key": (3, 40, 72, 0, 20, True),
}


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_flash_block_update_split_reference_matches_pallas(case, d):
    """The split update's fold order (each warp's range of live 64-key tiles
    from a fresh state, merged with the carried state per 16-row q tile)
    against the reference's Pallas kernel.  Half the rows carry a state,
    half start fresh.  A fully masked block, and every q tile that sees no
    key, keep the state exactly."""
    bh, tq, tk, q_off, k_off, causal = SPLIT_CASES[case]
    rng = np.random.default_rng(6 + d)
    m, l, o = (np.array(x) for x in _state(rng, bh, tq, d))
    m[:, ::2], l[:, ::2], o[:, ::2] = jra.NEG_INF, 0.0, 0.0
    _, tq_, jq = _bf16(rng, (bh, tq, d))
    _, tk_, jk = _bf16(rng, (bh, tk, d))
    _, tv_, jv = _bf16(rng, (bh, tk, d))
    ref = [np.asarray(x) for x in jra.flash_block_update(jq, jk, jv, q_off, k_off,
                                                         *map(jnp.asarray, (m, l, o)), causal)]
    mine = [x.numpy() for x in fa.flash_block_update_split_reference(
        tq_, tk_, tv_, q_off, k_off, *map(torch.from_numpy, (m, l, o)), causal)]
    for q0, ranges in fa._update_warp_ranges(tq, tk, causal, q_off, k_off):
        if all(lo == hi for lo, hi in ranges):  # sees no key: exactly as it was
            rows = slice(q0, q0 + fa.SPLIT_ROWS)
            for a, b in zip(mine, (m, l, o)):
                np.testing.assert_array_equal(a[:, rows], b[:, rows])
    (mm, ml, mo), (rm, rl, ro) = mine, ref
    assert _rel(mm, rm) <= STATE_RTOL and _rel(ml, rl) <= STATE_RTOL
    out, ref_out = (x / np.where(y > 0, y, 1.0)[..., None] for x, y in ((mo, ml), (ro, rl)))
    assert np.max(np.abs(out - ref_out)) <= OUT_TOL


@pytest.mark.parametrize("tq, tk, kw, expected", [
    (512, 512, {}, 512),
    (2048, 2048, {}, 512),
    (2048, 4096, {}, 256),
    (24, 4096, {"budget_bytes": 1 << 10}, 8),
    (40, 1 << 20, {}, 8),
])
def test_q_tile_matches_reference(tq, tk, kw, expected):
    assert tra._q_tile(tq, tk, **kw) == expected == jra._q_tile(tq, tk, **kw)


def test_q_tiled_plain_update_matches_single_tile(monkeypatch):
    """The plain block update tiles q by ``_q_tile``; a forced small tile
    must give the single-tile result (the path real shapes take)."""
    rng = np.random.default_rng(2)
    _, q, _ = _bf16(rng, (2, 64, 8))
    _, k, _ = _bf16(rng, (2, 64, 8))
    _, v, _ = _bf16(rng, (2, 64, 8))
    m = torch.full((2, 64), fa.NEG_INF)
    l, o = torch.zeros(2, 64), torch.zeros(2, 64, 8)
    whole = fa.flash_block_update_reference(q, k, v, 64, 32, m, l, o, True)
    monkeypatch.setattr(fa, "_q_tile", lambda tq, tk, **kw: 16)
    tiled = fa.flash_block_update_reference(q, k, v, 64, 32, m, l, o, True)
    for a, b in zip(tiled, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    rng = np.random.default_rng(3)
    (_, tq, jq), (_, tk, jk), (_, tv, jv) = (_bf16(rng, (2, 32, 2, 8)) for _ in range(3))
    ref = np.asarray(jra.reference_attention(jq, jk, jv, causal), np.float32)
    mine = tra.reference_attention(tq, tk, tv, causal)
    assert mine.dtype == torch.bfloat16
    np.testing.assert_allclose(mine.float().numpy(), ref, atol=OUT_TOL)


def test_merge_and_split_heads_match_jax():
    rng = np.random.default_rng(4)
    x, t, j = _bf16(rng, (2, 16, 3, 8))
    merged = tra.merge_heads(t)
    assert merged.is_contiguous()
    np.testing.assert_array_equal(merged.float().numpy(),
                                  np.asarray(jra.merge_heads(j), np.float32))
    np.testing.assert_array_equal(tra.split_heads(merged, 2, 3).float().numpy(), x)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel-path", "plain-path"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_forward_four_ranks_matches_jax_mesh(causal, use_kernel):
    """Four gloo ranks, each holding a 16-token block, against the
    reference's ring on a four-device mesh: the rotation, the global causal
    positions and the last hop without rotation.  The kernel path folds
    with bf16 weights where the reference's ring path keeps them f32."""
    rng = np.random.default_rng(5)
    (q, _, jq), (k, _, jk), (v, _, jv) = (_bf16(rng, (1, 64, 2, 8)) for _ in range(3))
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    ring = jax.jit(functools.partial(jra.ring_attention, mesh=mesh, causal=causal))
    ref = np.asarray(ring(jq, jk, jv), np.float32)
    mine = tra.ring_attention(q, k, v, causal, use_kernel=use_kernel, world_size=4, device="cpu")
    assert mine.shape == ref.shape
    assert np.max(np.abs(mine - ref)) <= OUT_TOL


def test_acceptance_on_four_ranks():
    r = tra.acceptance(seq_per_chip=16, heads=2, head_dim=8, world_size=4, use_kernel=True,
                       device="cpu")
    assert r["ok"] and r["devices"] == 4 and r["seq"] == 64
    assert r["max_error"] < OUT_TOL and r["kernel"] == "plain-flash"


def test_quick_check_keys_match_reference():
    r = tra.quick_check(device="cpu")
    assert r["ok"] and r["devices"] == 1 and r["backend"] == "cpu"
    assert r["launches"] == 0  # the CPU takes the plain version
    keys = {"ok", "devices", "seq", "seq_per_chip", "heads", "head_dim", "causal", "kernel",
            "max_error", "time_s", "backend"}  # the reference's acceptance() keys
    assert keys <= set(r)
