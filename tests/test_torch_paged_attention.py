"""Parity of kernel B5's paged f32 entry (``flash_attention_paged``, the
serving engine's flash attend) with the JAX reference, on the CPU.

The reference's engine gathers a request's pages into a zero-padded
``[H, T, D]`` copy and runs ``longctx.flash_attention_local`` (the Pallas
kernel, in interpret mode here) on an 8-row causal query tail at q_off =
L - 8, keeping the last row.  The port's paged call computes that row
alone, for every request at once, reading the pool through shuffled,
non-contiguous block tables.  Inputs are numpy draws from a seed; on the
CPU the wrapper takes its plain version.  The kernel itself is held against
the plain version on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator.workloads import longctx as jlc  # noqa: E402
from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402

FLASH_OUT_RTOL = 1e-5  # f32 out vs Pallas: of max |ref|
FLASH_LSE_RTOL = 1e-6  # f32 lse, relative
TAIL = 8               # the reference engine's query tail
BT = 16                # tokens a page, the engine's default
HEADS = 2
LENGTHS = (8, 16, 17, 31, 32, 33, 128, 40)  # page edges, the longest context, one more


@functools.lru_cache(maxsize=None)
def _requests(d: int) -> tuple:
    """Eight requests of ``LENGTHS`` at head dim ``d``: each its query q
    [H, D] and its tokens' K, V [L, H, D], and the Pallas reference's last
    tail row over them (out [R, H, D], lse [R, H]): an 8-row tail ending in
    q, against the K/V zero-padded to whole pages."""
    rng = np.random.default_rng(1000 + d)
    q = rng.standard_normal((len(LENGTHS), HEADS, d)).astype(np.float32)
    ks, vs = [], []
    ref_out = np.zeros_like(q)
    ref_lse = np.zeros(q.shape[:2], np.float32)
    for r, n in enumerate(LENGTHS):
        pad = BT * -(-n // BT)
        k, v = (np.zeros((HEADS, pad, d), np.float32) for _ in range(2))
        k[:, :n] = rng.standard_normal((HEADS, n, d))
        v[:, :n] = rng.standard_normal((HEADS, n, d))
        tail = rng.standard_normal((HEADS, TAIL, d)).astype(np.float32)
        tail[:, -1] = q[r]
        out, lse = jlc.flash_attention_local(tail, k, v, causal=True, block_k=BT,
                                             block_q=TAIL, q_off=n - TAIL)
        ref_out[r], ref_lse[r] = np.asarray(out)[:, -1], np.asarray(lse)[:, -1]
        ks.append(k[:, :n].transpose(1, 0, 2))
        vs.append(v[:, :n].transpose(1, 0, 2))
    return q, ks, vs, (ref_out, ref_lse)


@functools.lru_cache(maxsize=None)
def _batch(d: int, order: str = "random") -> tuple:
    """``_requests(d)`` written into a pool of noise: each request's pages
    taken from a seeded permutation of the pool (``random``) or from a run
    of it, reversed; the slots past a length and the unused blocks noise,
    table entries past the live pages -1.  Returns numpy (q, k_pool, v_pool
    [blocks, BT, H, D], tables [R, width] int32, lengths [R] int32) and the
    reference rows."""
    q, ks, vs, refs = _requests(d)
    rng = np.random.default_rng(2000 + d)
    pages = [-(-n // BT) for n in LENGTHS]
    blocks = sum(pages) + 5
    k_pool, v_pool = (rng.standard_normal((blocks, BT, HEADS, d)).astype(np.float32)
                      for _ in range(2))
    perm = rng.permutation(blocks)
    tables = np.full((len(LENGTHS), max(pages)), -1, np.int32)
    taken = 0
    for r, (n, p) in enumerate(zip(LENGTHS, pages)):
        tables[r, :p] = perm[taken:taken + p] if order == "random" else \
            np.arange(taken, taken + p)[::-1]
        taken += p
        for t in range(n):
            k_pool[tables[r, t // BT], t % BT] = ks[r][t]
            v_pool[tables[r, t // BT], t % BT] = vs[r][t]
    return (q, k_pool, v_pool, tables, np.asarray(LENGTHS, np.int32)), refs


def _paged(q, k_pool, v_pool, tables, lengths):
    return fa.flash_attention_paged(*(torch.from_numpy(np.ascontiguousarray(a))
                                      for a in (q, k_pool, v_pool, tables, lengths)))


def _assert_close(out, lse, ref_out, ref_lse):
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    out, lse = out.numpy(), lse.numpy()
    assert np.abs(out - ref_out).max() <= FLASH_OUT_RTOL * np.abs(ref_out).max()
    assert (np.abs(lse - ref_lse) / np.abs(ref_lse)).max() <= FLASH_LSE_RTOL


@pytest.mark.parametrize("order", ["random", "reverse"])
@pytest.mark.parametrize("d", [8, 16, 128])
def test_paged_batch_matches_pallas_tail_row(d, order):
    """R 8: the step's eight requests in one call, against row -1 of the
    reference's per-request flash call over the gathered, zero-padded
    pages; tables in a random permutation of the pool, or reversed."""
    inputs, (ref_out, ref_lse) = _batch(d, order)
    _assert_close(*_paged(*inputs), ref_out, ref_lse)


@pytest.mark.parametrize("length", LENGTHS[:7])
@pytest.mark.parametrize("d", [8, 16, 128])
def test_paged_single_request_matches_pallas_tail_row(d, length):
    """R 1: each length alone, its own table row of the shuffled pool."""
    (q, k_pool, v_pool, tables, lengths), (ref_out, ref_lse) = _batch(d)
    r = LENGTHS.index(length)
    out, lse = _paged(q[r:r + 1], k_pool, v_pool, tables[r:r + 1], lengths[r:r + 1])
    _assert_close(out, lse, ref_out[r:r + 1], ref_lse[r:r + 1])


@pytest.mark.parametrize("d", [16, 128])
def test_paged_row_is_independent_of_the_batch(d):
    """A request's output is the same bits alone, in the full batch and in
    the batch reversed: a row depends only on its own pages and length."""
    q, k_pool, v_pool, tables, lengths = _batch(d)[0]
    full = _paged(q, k_pool, v_pool, tables, lengths)
    back = _paged(q[::-1], k_pool, v_pool, tables[::-1], lengths[::-1])
    for r in range(len(LENGTHS)):
        alone = _paged(q[r:r + 1], k_pool, v_pool, tables[r:r + 1], lengths[r:r + 1])
        for a, b, c in zip(alone, full, back):
            assert torch.equal(a[0], b[r]) and torch.equal(a[0], c[len(LENGTHS) - 1 - r])


def test_paged_length_zero_is_exact_and_blind():
    """A request of length 0 gives out exactly 0 and lse exactly NEG_INF,
    and its table (all -1) is never read; the requests beside it keep
    their values."""
    (q, k_pool, v_pool, tables, lengths), (ref_out, ref_lse) = _batch(16)
    lengths = lengths.copy()
    lengths[2] = 0
    tables = tables.copy()
    tables[2] = -1
    out, lse = _paged(q, k_pool, v_pool, tables, lengths)
    assert not out[2].any() and bool((lse[2] == fa.NEG_INF).all())
    keep = [r for r in range(len(LENGTHS)) if r != 2]
    _assert_close(out[keep], lse[keep], ref_out[keep], ref_lse[keep])


def test_paged_pages_past_the_length_are_never_read():
    """Table entries past a request's live pages may hold anything: the
    result is the same bits whatever they name."""
    q, k_pool, v_pool, tables, lengths = _batch(16)[0]
    other = tables.copy()
    for r, n in enumerate(LENGTHS):
        other[r, -(-n // BT):] = 0
    for a, b in zip(_paged(q, k_pool, v_pool, tables, lengths),
                    _paged(q, k_pool, v_pool, other, lengths)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("length, block_tokens, splits", [
    (0, 16, 1), (1, 16, 1), (512, 16, 1), (513, 16, 2), (4096, 16, 8), (3585, 16, 8),
    (256, 8, 1), (257, 8, 2), (10 ** 6, 16, fa.PAGED_MAX_SPLITS),
])
def test_paged_split_count_is_the_rows_own(length, block_tokens, splits):
    """The key splits of a row come from its own live pages, one per
    ``PAGED_SPLIT_PAGES``, capped: never from the batch; the engine's
    contexts (at most 128 tokens) take one split, so its step is one
    launch."""
    assert fa._paged_split_count(length, block_tokens) == splits
    assert fa._paged_split_count(128, 16) == 1


def _args(d=16, dtype=torch.float32, table_dtype=torch.int32):
    q = torch.zeros(2, HEADS, d, dtype=dtype)
    pool = torch.zeros(4, BT, HEADS, d, dtype=dtype)
    return [q, pool, pool.clone(), torch.zeros(2, 2, dtype=table_dtype),
            torch.ones(2, dtype=table_dtype)]


@pytest.mark.parametrize("args, err", [
    (_args(dtype=torch.float64), TypeError),
    (_args(dtype=torch.bfloat16), TypeError),
    (_args(table_dtype=torch.int64), TypeError),
    (_args(d=136), ValueError),
    ([*_args()[:3], torch.zeros(3, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)],
     ValueError),
    ([_args()[0], torch.zeros(4, BT, HEADS + 1, 16), *_args()[2:]], ValueError),
    ([*_args()[:4], torch.ones(2, dtype=torch.int32, device="meta")], ValueError),
    ([_args()[0].transpose(0, 1).contiguous().transpose(0, 1), *_args()[1:]], ValueError),
], ids=["f64", "bf16", "int64-tables", "head-dim-136", "table-rows", "pool-heads",
        "mixed-devices", "non-contiguous"])
def test_paged_wrapper_refuses_what_the_kernel_does_not_take(args, err):
    before = dict(fa.forward_path_launches)
    with pytest.raises(err):
        fa.flash_attention_paged(*args)
    assert fa.forward_path_launches == before


def test_paged_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper returns the plain version's bits and launches
    nothing: its kernel counter stays where it was."""
    inputs = [torch.from_numpy(np.ascontiguousarray(a)) for a in _batch(16)[0]]
    before, total = dict(fa.forward_path_launches), fa.forward_launches
    got = fa.flash_attention_paged(*inputs)
    want = fa.flash_attention_paged_reference(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.forward_path_launches == before and fa.forward_launches == total
