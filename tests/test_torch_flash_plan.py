"""The forward's plan and its split over the keys, and the block update's
cut of the keys (``tpu_operator_torch.kernels.flash_attention``), on the
CPU.

``flash_attention_split_reference`` cuts the keys as the split kernel does
and merges the partial states as its combine pass does; here it is held
against the JAX package's Pallas kernel (interpret mode, as the reference's
own tests run it), so the split algorithm is pinned where no kernel can
run.  Inputs are made with numpy from a seed, rounded to bf16 once and
handed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from tpu_operator.workloads import longctx as jlc  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402
from tpu_operator_torch.workloads import longctx as tlc  # noqa: E402

OUT_TOL = 2e-2     # bf16 outputs
STATE_RTOL = 1e-3  # lse: f32, sums in another order
N_SM = 132         # an H100 SXM's SMs
TK = 256


def _merged(rng, b, t, h, d):
    """(torch, jax) merged-layout [B*H, T, D] bf16 tensors with the same
    values."""
    x = torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32)).bfloat16()
    return tlc._merge(x), jlc._merge(jnp.asarray(x.float().numpy(), jnp.bfloat16))


def _tail_inputs(seed, d, tq=8):
    """A ``tq``-row query tail and a TK-key cache, 1 x 2 heads."""
    rng = np.random.default_rng(seed)
    (tq_, jq), (tk, jk), (tv, jv) = (_merged(rng, 1, TK, 2, d) for _ in range(3))
    return (tq_[:, -tq:].contiguous(), tk, tv), (jq[:, -tq:], jk, jv)


def _compare(mine, ref):
    out, lse = mine
    ref_out, ref_lse = (np.asarray(r, np.float32) for r in ref)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
    assert np.max(np.abs(out.float().numpy() - ref_out)) <= OUT_TOL
    rel = np.abs(lse.numpy() - ref_lse) / np.maximum(np.abs(ref_lse), 1.0)
    assert np.max(rel) <= STATE_RTOL


@pytest.mark.parametrize("n_splits", [1, 3, 7], ids=["one", "uneven", "more-than-tiles"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
@pytest.mark.parametrize("d", [8, 16])
def test_split_decode_tail_matches_pallas(d, causal, n_splits):
    """Tq 8 at q_off = Tk - 8: 4 tiles of 64 keys cut into 1, 3 (uneven)
    and 7 ranges (three of them empty)."""
    mine, ref = _tail_inputs(20 + d, d)
    q_off = TK - 8
    want = jlc.flash_attention_local(*ref, causal, block_k=64, q_off=q_off)
    _compare(fa.flash_attention_split_reference(*mine, causal, n_splits, q_off), want)


@pytest.mark.parametrize("n_splits", [2, 3])
def test_split_with_splits_some_rows_cannot_see(n_splits):
    """Rows at positions 60..67: the split holding keys 64..127 is masked
    whole for rows 60..63, which must come out of the merge unchanged."""
    mine, ref = _tail_inputs(31, 16)
    want = jlc.flash_attention_local(*ref, True, block_k=64, q_off=60)
    _compare(fa.flash_attention_split_reference(*mine, True, n_splits, 60), want)


@pytest.mark.parametrize("n_splits", [1, 3])
def test_split_rows_that_see_no_key_give_zero_and_neg_inf(n_splits):
    """k_off > q_off + Tq: every row masked in every split; out exactly 0
    and lse exactly NEG_INF, as the reference's guard gives."""
    mine, ref = _tail_inputs(32, 8)
    out, lse = fa.flash_attention_split_reference(*mine, True, n_splits, q_off=0, k_off=64)
    ref_out, ref_lse = jlc.flash_attention_local(*ref, True, k_off=64)
    assert not out.float().any() and not np.asarray(ref_out, np.float32).any()
    assert bool((lse == fa.NEG_INF).all()) and bool(jnp.all(ref_lse == jlc.NEG_INF))


def _partial(seed, s=1, bh=2, tq=8, d=16):
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn((s, bh, tq), generator=gen) * 3
    l = torch.rand((s, bh, tq), generator=gen) * 5 + 0.5
    acc = torch.randn((s, bh, tq, d), generator=gen)
    return m, l, acc


def test_merge_of_one_partial_gives_it_back():
    m, l, acc = _partial(0)
    out, lse = fa.merge_partials(m, l, acc)
    torch.testing.assert_close(out, acc[0] / l[0][..., None], rtol=1e-6, atol=0)
    torch.testing.assert_close(lse, m[0] + torch.log(l[0]), rtol=1e-6, atol=0)


def test_merge_takes_an_all_masked_partial_as_a_no_op():
    m, l, acc = _partial(1, s=2)
    masked = (torch.full_like(m[:1], fa.NEG_INF), torch.zeros_like(l[:1]),
              torch.zeros_like(acc[:1]))
    want = fa.merge_partials(m, l, acc)
    for where in (0, 1, 2):  # first, middle, last
        got = fa.merge_partials(*(torch.cat([x[:where], y, x[where:]])
                                  for x, y in zip((m, l, acc), masked)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_merge_of_all_masked_partials_is_zero_and_neg_inf():
    m, l, acc = _partial(2, s=3)
    out, lse = fa.merge_partials(torch.full_like(m, fa.NEG_INF), torch.zeros_like(l),
                                 torch.zeros_like(acc), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and not out.float().any()
    assert bool((lse == fa.NEG_INF).all())


PREFILL = (8, 32768, 32768, 128, True, 0, 0)
DECODE = (8, 8, 32768, 128, True, 32760, 0)


@pytest.mark.parametrize("shape, path", [
    (PREFILL, "wgmma"),
    ((8, 4096, 4096, 128, False, 0, 0), "wgmma"),
    ((2, 200, 200, 64, True, 0, 0), "wgmma"),
    (DECODE, "split"),
    ((8, 1, 32768, 128, True, 32767, 0), "split"),
    ((8, 8, 32808, 128, True, 32800, 0), "split"),
    ((1, 8, 32768, 128, True, 32760, 0), "split"),
    ((8, 8, 32768, 128, False, 0, 0), "split"),
    ((4, 40, 40, 8, True, 0, 0), "mma"),
    ((4, 40, 40, 16, True, 0, 0), "mma"),
    ((4, 136, 136, 8, True, 0, 0), "mma"),
    ((4, 136, 136, 16, True, 0, 0), "mma"),
    ((8, 4096, 4096, 32, True, 0, 0), "mma"),
    ((8, 100, 100, 128, True, 0, 0), "mma"),        # Tq below one 128-row tile
    ((8, 8, 256, 128, True, 248, 0), "mma"),        # too few tiles to split
    ((8, 8, 32768, 128, True, 0, 0), "mma"),        # causal: 1 live tile
    ((256, 8, 32768, 128, True, 32760, 0), "mma"),  # the mma grid fills the card
], ids=lambda x: x if isinstance(x, str) else "x".join(map(str, x[:4])))
def test_forward_plan_picks_the_path(shape, path):
    assert fa._forward_plan(*shape, N_SM)[0] == path


def test_decode_plan_covers_the_card():
    bh = DECODE[0]
    path, n_splits = fa._forward_plan(*DECODE, N_SM)
    assert path == "split" and bh * n_splits >= N_SM
    n_tiles = DECODE[2] // fa.SPLIT_TILE
    assert n_splits <= n_tiles // fa.MIN_SPLIT_TILES


@pytest.mark.parametrize("bh", [1, 2, 8, 64])
@pytest.mark.parametrize("tq", [1, 8, 16])
@pytest.mark.parametrize("tk", [512, 4096, 32808])
def test_every_planned_split_is_non_empty(bh, tq, tk):
    for causal, q_off in ((True, tk - tq), (True, tk // 2), (False, 0)):
        path, n_splits = fa._forward_plan(bh, tq, tk, 128, causal, q_off, 0, N_SM)
        if path != "split":
            assert n_splits == 1
            continue
        n_tiles = -(-fa._live_keys(tq, tk, causal, q_off, 0) // fa.SPLIT_TILE)
        assert 2 <= n_splits <= n_tiles
        assert all(hi - lo >= fa.MIN_SPLIT_TILES for lo, hi in fa._split_ranges(n_tiles, n_splits))


def test_split_reference_matches_the_plain_forward_on_the_decode_plan():
    """The plan's own split count at a cache of 2048 keys, against the
    plain forward of the port (both torch, f32 state)."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, n, 16), generator=gen).bfloat16() for n in (8, 2048, 2048))
    path, n_splits = fa._forward_plan(2, 8, 2048, 16, True, 2040, 0, N_SM)
    assert path == "split"
    out, lse = fa.flash_attention_split_reference(q, k, v, True, n_splits, 2040)
    ref_out, ref_lse = fa.flash_attention_local_reference(q, k, v, True, q_off=2040)
    assert float((out.float() - ref_out.float()).abs().max()) <= OUT_TOL
    assert float(((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max()) <= 1e-5


RING_HOP = (4, 512)  # the ring-attention check's hop per card: BH, Tq


def test_ring_hop_split_fills_the_card():
    """The ring hop on the split update: one 16-row block per q tile and
    head, one wave on an H100's SMs, at most 2 of the 8 tiles per warp."""
    bh, tq = RING_HOP
    ranges = fa._update_warp_ranges(tq, tq, True, 0, 0)
    assert bh * len(ranges) == 128 <= N_SM
    assert max(hi - lo for _, warps in ranges for lo, hi in warps) == 2


def _visible_tiles(q0, q_end, tk, causal, q_off, k_off) -> set:
    """The 64-key tiles in which some row of [q0, q_end) sees some key,
    by enumerating the (row, key) pairs."""
    rows = q_off + np.arange(q0, q_end)[:, None]
    keys = np.arange(tk)[None, :]
    seen = np.ones((q_end - q0, tk), bool) if not causal else rows >= k_off + keys
    return set(np.unique(np.nonzero(seen)[1] // fa.SPLIT_TILE).tolist())


@settings(max_examples=300, deadline=None, database=None)
@given(tq=st.integers(1, 80), tk=st.integers(1, 400), causal=st.booleans(),
       q_off=st.integers(0, 500), k_off=st.integers(0, 500))
def test_update_warp_ranges_cover_each_live_tile_once(tq, tk, causal, q_off, k_off):
    """Every 16-row q tile: its warps' ranges are contiguous, in order, and
    together hold each tile in which the q tile sees a key exactly once,
    and no tile in which it sees none."""
    ranges = fa._update_warp_ranges(tq, tk, causal, q_off, k_off)
    assert [q0 for q0, _ in ranges] == list(range(0, tq, fa.SPLIT_ROWS))
    for q0, warps in ranges:
        assert len(warps) == fa.SPLIT_WARPS
        assert all(a[1] == b[0] for a, b in zip(warps, warps[1:]))
        tiles = [t for lo, hi in warps for t in range(lo, hi)]
        want = _visible_tiles(q0, min(q0 + fa.SPLIT_ROWS, tq), tk, causal, q_off, k_off)
        assert sorted(tiles) == tiles and len(set(tiles)) == len(tiles)
        assert set(tiles) == want
