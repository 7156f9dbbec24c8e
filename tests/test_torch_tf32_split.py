"""The numerics of the training kernels' f32 route (``csrc/flash_backward.cu``):
every product as 3xTF32 on the tensor cores, never as one TF32 pass.

The card's ``cvt.rna.tf32.f32`` is emulated on f32 tensors with the integer
rounding the kernels use in its place (``tf32`` in the source); B4's five
products and B3's fold run through emulated 3xTF32 and 1xTF32 against float64
at the train path's shapes cut down, causal, on inputs made from numpy seeds.
3xTF32 stays within 1e-5 of max |float64| on every output; a single TF32
pass lands beyond the card's f32 limit (``F32_RTOL`` in ``chip_smoke.py``),
so the kernel-vs-plain checks there would catch a lost lo term.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_operator_torch.kernels import flash_attention as fa  # noqa: E402

F32_RTOL = 1e-4     # the card's limit for the f32 kernels against their plain versions
SPLIT_RTOL = 1e-5   # 3xTF32: plain f32 products land near 1e-6 here


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round an f32 to 10 mantissa bits, to nearest,
    ties away from zero (add half of the dropped 13 bits' unit to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_1xtf32(a, b):
    return torch.matmul(tf32(a), tf32(b))


def mm_3xtf32(a, b):
    """a b as the kernel accumulates it: a_lo b_hi + a_hi b_lo, then a_hi b_hi,
    in f32; each TF32 product is exact in f32 (11 x 11 significant bits)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    acc = torch.matmul(a_lo, b_hi)
    acc = acc + torch.matmul(a_hi, b_lo)
    return acc + torch.matmul(a_hi, b_hi)


def _causal_mask(t):
    return torch.arange(t)[:, None] >= torch.arange(t)[None, :]


def backward(q, k, v, do, lse, dsum, mm):
    """B4's five products with the reference's numerics (f32 storage: nothing
    rounded between them): dq, dk, dv of one causal diagonal hop."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    s = torch.where(_causal_mask(q.shape[1]), s, fa.NEG_INF)
    p = torch.where(s <= fa.NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None]))
    dv = mm(p.transpose(-1, -2), do)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - dsum[..., None])
    return mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale, dv


def fold(q, k, v, mm):
    """B3's fold of one causal diagonal block into a fresh state: S = Q K^T
    and O = e V; returns (out = o / l, l)."""
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = torch.where(_causal_mask(q.shape[1]), s, fa.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1)
    return mm(e, v) / l[..., None], l


def _inputs(bh, t, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, t, d)).astype(np.float32))
            for _ in range(4)]


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),   # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                # below half: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),
    (2.0 - 2.0 ** -23, 2.0),                # carries into the exponent
    (0.0, 0.0),
])
def test_tf32_rounding_emulation(x, want):
    assert float(tf32(torch.tensor([x], dtype=torch.float32))[0]) == want


def test_split_terms_recover_f32():
    """hi + lo holds 22 of an f32's 24 significant bits: within 2^-21."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi = tf32(x)
    rest = (x.double() - hi.double() - tf32(x - hi).double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("bh, t, d", [(2, 512, 128), (4, 256, 32)])
def test_backward_needs_the_split(bh, t, d):
    q, k, v, do = _inputs(bh, t, d, seed=bh * t + d)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    s = torch.where(_causal_mask(t), q64 @ k64.transpose(-1, -2) * scale, -math.inf)
    lse64 = torch.logsumexp(s, -1)
    dsum64 = (do64 * (torch.softmax(s, -1) @ v64)).sum(-1)
    want = backward(q64, k64, v64, do64, lse64, dsum64, torch.matmul)
    args = (q, k, v, do, lse64.float(), dsum64.float())
    split = [_rel(g, w) for g, w in zip(backward(*args, mm_3xtf32), want)]
    single = [_rel(g, w) for g, w in zip(backward(*args, mm_1xtf32), want)]
    assert max(split) <= SPLIT_RTOL, split
    assert min(single) > F32_RTOL, single


@pytest.mark.parametrize("bh, t, d", [(2, 512, 128), (4, 256, 32)])
def test_fold_needs_the_split(bh, t, d):
    q, k, v, _ = _inputs(bh, t, d, seed=7 * bh + t + d)
    want = fold(q.double(), k.double(), v.double(), torch.matmul)
    split = [_rel(g, w) for g, w in zip(fold(q, k, v, mm_3xtf32), want)]
    single = [_rel(g, w) for g, w in zip(fold(q, k, v, mm_1xtf32), want)]
    assert max(split) <= SPLIT_RTOL, split
    assert min(single) > F32_RTOL, single
