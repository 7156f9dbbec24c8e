"""The flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_forward_sm90.cu``, ``csrc/flash_forward_f32.cu``) and their
plain PyTorch versions.

- ``flash_attention_local`` replaces the Pallas TPU kernel
  ``_flash_full_kernel`` (``tpu_operator/workloads/longctx.py:47-150``):
  the full forward, causal or not, returning out and the log-sum-exp.  On
  bf16 q/k/v it runs one of three kernels, chosen per call by
  ``_forward_plan``: the ``wgmma`` + TMA kernel for long prefills at D 64
  and 128, a split over the keys for short query tails against long caches
  (the decode), and the ``mma.sync`` kernel for everything else; f32 q/k/v
  take the ``f32`` kernel;
- ``flash_attention_paged`` is the same kernel's f32 entry as the serving
  engine calls it: one decode row per (request, head) over the KV pool,
  read in place through each request's block table, every request of a
  decode step in one launch (the row that the reference's engine keeps of
  its 8-row tail over gathered pages);
- ``flash_block_update`` replaces ``_flash_block_kernel``
  (``tpu_operator/workloads/ring_attention.py:118-218``): one K/V block
  folded into the carried (m, l, o) state, in place.  bf16 q/k/v go to the
  ``mma.sync`` entry here, 16-row q tiles whose warps split the live keys
  (the ring hop's 4 x 512 rows fill the card that way); f32 q/k/v, the
  transformer step's (its weights are f32), to ``tpu_flash_block_update_f32``
  in ``csrc/flash_backward.cu`` (3xTF32 ``mma.sync``: f32 products on the
  tensor cores).

``workloads/longctx.py`` and ``workloads/ring_attention.py`` re-export them
under the same names, the reference's.

``flash_attention_local`` and ``flash_block_update`` run
``online_softmax_block_update`` (``ring_attention.py:86-115``), whose plain
version is here too.  Layout ``[BH, T, D]``; q, k, v bf16 or f32, the state
f32.  A wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_operator_torch.kernels import _build

NEG_INF = -1e30  # large-negative instead of -inf: exp() of a fully masked
# row must give 0 through the guard, never nan from (-inf) - (-inf)

# launches of each CUDA kernel in this process: a run shows it went through
# the kernel by reading these before and after (chip_smoke.py sets them to 0)
forward_launches = 0           # every path of the forward
forward_path_launches = {"wgmma": 0, "split": 0, "mma": 0, "f32": 0, "paged_f32": 0}
FORWARD_PATHS = ("wgmma", "split", "mma", "f32")  # what ``_flash_forward_on`` takes
block_update_launches = 0      # the bf16 entry
block_update_f32_launches = 0  # the f32 entry

MAX_HEAD_DIM = 128

# the forward's plan (``_forward_plan``)
MMA_ROWS = 64             # query rows per block of the mma kernel
SPLIT_TILE = 64           # keys per tile of the split kernel
SPLIT_ROWS = 16           # query rows per block of the split kernel
SPLIT_WARPS = 4           # warps per block of the split kernel, each its own key range
MIN_SPLIT_TILES = 4       # tiles per split at least: one per warp of the block
WGMMA_ROWS = 128          # query rows per block of the wgmma kernel
WGMMA_HEAD_DIMS = (64, 128)
FORWARD_DTYPES = (torch.bfloat16, torch.float32)  # f32: the serving engine's
PAGED_SPLIT_PAGES = 32    # the paged kernel's pages per key split (512 keys at 16-token pages)
PAGED_MAX_SPLITS = 32     # at most this many splits a row (their partials' scratch)


def _block_div(t: int, want: int) -> int:
    """Largest divisor of ``t`` that is <= ``want`` and a multiple of 8;
    ``t`` itself only when no aligned divisor exists (tiny shapes).  The
    reference's tiling rule (``longctx.py:84-93``), kept by the plain
    version so that it folds the same blocks as the TPU kernel."""
    if t <= want:
        return t
    for blk in range(min(t, want - want % 8), 7, -8):
        if t % blk == 0:
            return blk
    return t


def _q_tile(tq: int, tk: int, budget_bytes: int = 4 << 20) -> int:
    """Largest divisor of ``tq`` (multiple of 8) whose [blk_q, Tk] f32 score
    block fits ``budget_bytes``; ``tq`` itself when it already fits.  The
    reference's q tiling of the block update (``ring_attention.py:132-142``);
    the plain version tiles by it, which also bounds its score memory."""
    target = max(8, budget_bytes // (tk * 4))
    if tq <= target:
        return tq
    for blk in range(min(tq, target - target % 8), 7, -8):
        if tq % blk == 0:
            return blk
    return tq


def _live_keys(tq: int, tk: int, causal: bool, q_off: int, k_off: int) -> int:
    """Keys [0, n) that some query row can see: all of them unless causal,
    else those at or before the last row's position ``q_off + tq - 1``."""
    if not causal:
        return tk
    return max(0, min(tk, q_off + tq - k_off))


def _split_ranges(n_tiles: int, n_splits: int) -> list:
    """The split kernel's cut of ``n_tiles`` key tiles into ``n_splits``
    contiguous ranges [lo, hi), as even as integers allow; empty ranges
    only when there are more splits than tiles."""
    return [(n_tiles * s // n_splits, n_tiles * (s + 1) // n_splits) for s in range(n_splits)]


def _split_count(bh: int, tq: int, n_tiles: int, n_sm: int) -> int:
    """Splits enough for ``bh * ceil(tq / 16) * n`` blocks to cover the SMs
    twice, capped so each keeps ``MIN_SPLIT_TILES`` of the ``n_tiles``
    live tiles; at least 1."""
    row_blocks = bh * -(-tq // SPLIT_ROWS)
    return max(1, min(-(-2 * n_sm // row_blocks), n_tiles // MIN_SPLIT_TILES))


def _paged_split_count(length: int, block_tokens: int) -> int:
    """The paged kernel's key splits for a row of ``length`` keys: one per
    ``PAGED_SPLIT_PAGES`` live pages, at least 1, at most
    ``PAGED_MAX_SPLITS``.  A function of the row's own length only, so a
    request's result never depends on the batch beside it; the kernel
    computes the same count (``split_count`` in ``csrc/flash_forward_f32.cu``)."""
    pages = -(-max(0, length) // block_tokens)
    return max(1, min(PAGED_MAX_SPLITS, -(-pages // PAGED_SPLIT_PAGES)))


def _update_warp_ranges(tq: int, tk: int, causal: bool, q_off: int, k_off: int) -> list:
    """The bf16 block update's cut of the keys: for each 16-row q tile (from row
    ``q0``), its live 64-key tiles (``_live_keys`` of its rows) cut into one
    contiguous range per warp by ``_split_ranges``.  Returns ``[(q0,
    [(lo, hi)] * 4)]``; a q tile with no live tile has only empty ranges."""
    out = []
    for q0 in range(0, tq, SPLIT_ROWS):
        live = _live_keys(min(SPLIT_ROWS, tq - q0), tk, causal, q_off + q0, k_off)
        out.append((q0, _split_ranges(-(-live // SPLIT_TILE), SPLIT_WARPS)))
    return out


def _forward_plan(bh: int, tq: int, tk: int, d: int, causal: bool, q_off: int, k_off: int,
                  n_sm: int, dtype=torch.bfloat16) -> tuple:
    """Which kernel runs a forward call, and over how many key ranges:
    ``(path, n_splits)``.

    Every f32 call (``dtype``) takes ``f32``, the contiguous f32 forward
    (the serving engine calls ``flash_attention_paged`` instead).  A bf16
    call takes:

    - ``split`` when the query side is a short tail (``tq <= SPLIT_ROWS``),
      the mma kernel's ``bh * ceil(tq / 64)`` blocks cannot fill the
      ``n_sm`` SMs, and the live keys span at least two splits of
      ``MIN_SPLIT_TILES`` 64-key tiles: the decode.  ``n_splits`` makes
      ``bh * ceil(tq / 16) * n_splits`` blocks cover the SMs twice, capped
      so every split keeps ``MIN_SPLIT_TILES`` tiles (one per warp).
    - ``wgmma`` when D is 64 or 128 and Tq fills at least one 128-row q
      tile: the prefill.
    - ``mma`` for everything else: D 8 to 32, short sequences.
    ``n_splits`` is 1 on the paths that do not split."""
    if dtype == torch.float32:
        return "f32", 1
    n_tiles = -(-_live_keys(tq, tk, causal, q_off, k_off) // SPLIT_TILE)
    blocks = bh * -(-tq // MMA_ROWS)
    if tq <= SPLIT_ROWS and blocks < n_sm and n_tiles >= 2 * MIN_SPLIT_TILES:
        return "split", _split_count(bh, tq, n_tiles, n_sm)
    if d in WGMMA_HEAD_DIMS and tq >= WGMMA_ROWS:
        return "wgmma", 1
    return "mma", 1


# ---------------------------------------------------------------------------
# plain versions


def online_softmax_block_update(causal, scale, q, k, v, m, l, acc, q_base, k_base):
    """Fold one K/V block's scores into the (m, l, acc) online-softmax state;
    the reference's numerics exactly: f32 scores of the storage-dtype
    inputs, scaled after the product; masked scores NEG_INF; the fully
    masked guard; ``l`` sums the f32 ``e``; the PV product takes ``e``
    rounded to v's dtype, accumulated in f32.

    Shapes: q [..., Bq, D], k/v [..., Bk, D], m/l [..., Bq, 1], acc
    [..., Bq, D] (leading dims batch, the reference's are absent).
    Returns the new (m, l, acc)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_base + torch.arange(q.shape[-2], device=q.device)
        k_pos = k_base + torch.arange(k.shape[-2], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    blk_max = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, blk_max)
    corr = torch.exp(m - m_new)
    e = torch.exp(s - m_new)
    e = torch.where(s <= NEG_INF * 0.5, 0.0, e)  # fully masked guard
    pv = torch.matmul(e.to(v.dtype).float(), v.float())
    return m_new, l * corr + e.sum(dim=-1, keepdim=True), acc * corr + pv


def flash_attention_local_reference(q, k, v, causal=True, block_k=1024, block_q=1024,
                                    q_off=0, k_off=0):
    """The plain full forward: the update above over (q-tile, k-block), the
    tiles chosen by ``_block_div`` as the TPU kernel's grid, batched over
    BH, and k-blocks past the tile's last query skipped when causal.
    Memory stays at one [BH, block_q, block_k] score tile.  Returns
    (out [BH, Tq, D] in q's dtype, lse [BH, Tq] f32)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    block_k = _block_div(tk, block_k)
    block_q = _block_div(tq, block_q)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    for i in range(0, tq, block_q):
        q_base = q_off + i
        m = torch.full((bh, block_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, block_q, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, block_q, d), dtype=torch.float32, device=q.device)
        for j in range(0, tk, block_k):
            k_base = k_off + j
            if causal and k_base > q_base + block_q - 1:
                continue
            m, l, acc = online_softmax_block_update(
                causal, scale, q[:, i:i + block_q], k[:, j:j + block_k], v[:, j:j + block_k],
                m, l, acc, q_base, k_base,
            )
        denom = torch.where(l > 0, l, 1.0)
        out[:, i:i + block_q] = (acc / denom).to(q.dtype)
        lse[:, i:i + block_q] = (m + torch.log(denom))[..., 0]
    return out, lse


def merge_partials(m, l, acc, out_dtype=torch.float32):
    """The split's combine pass: partial states m, l ``[S, BH, Tq]`` and
    acc ``[S, BH, Tq, D]`` (f32, unnormalized) merged into (out ``[BH, Tq,
    D]`` in ``out_dtype``, lse ``[BH, Tq]``).  m* = max over splits,
    l* = sum l_s exp(m_s - m*), out = sum acc_s exp(m_s - m*) / l*; a
    split that saw no key, (NEG_INF, 0, 0), adds nothing, and a row that
    saw none gives out 0 and lse exactly NEG_INF."""
    m_star = m.amax(dim=0)
    f = torch.exp(m - m_star)
    l_star = (l * f).sum(dim=0)
    acc_star = (acc * f[..., None]).sum(dim=0)
    denom = torch.where(l_star > 0, l_star, 1.0)
    return (acc_star / denom[..., None]).to(out_dtype), m_star + torch.log(denom)


def flash_attention_split_reference(q, k, v, causal, n_splits, q_off=0, k_off=0):
    """The plain split over the keys: the live keys cut into ``n_splits``
    contiguous ranges of 64-key tiles as the split kernel cuts them
    (``_split_ranges``), each range folded from a fresh state by
    ``online_softmax_block_update``, the partial states merged by
    ``merge_partials``.  Returns (out [BH, Tq, D] in q's dtype, lse [BH, Tq]
    f32)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    n_tiles = -(-_live_keys(tq, tk, causal, q_off, k_off) // SPLIT_TILE)
    parts = []
    for lo, hi in _split_ranges(n_tiles, n_splits):
        state = (torch.full((bh, tq, 1), NEG_INF, dtype=torch.float32, device=q.device),
                 torch.zeros((bh, tq, 1), dtype=torch.float32, device=q.device),
                 torch.zeros((bh, tq, d), dtype=torch.float32, device=q.device))
        a, b = lo * SPLIT_TILE, min(hi * SPLIT_TILE, tk)
        if b > a:
            state = online_softmax_block_update(causal, scale, q, k[:, a:b], v[:, a:b], *state,
                                                q_off, k_off + a)
        parts.append(state)
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    return merge_partials(m[..., 0], l[..., 0], acc, q.dtype)


def flash_attention_paged_reference(q, k_pool, v_pool, block_tables, lengths):
    """The plain paged decode, request by request: request r's first
    ``lengths[r]`` tokens gathered from the pools through its block table
    (token p at ``pool[block_tables[r, p // block_tokens], p % block_tokens]``),
    attended by its query row per head: out = softmax(q . K^T / sqrt(D)) V,
    lse = log sum exp of the scores, in f32.  A request of length 0 gives
    out 0 and lse exactly NEG_INF.  Entries of a table past its request's
    live pages are never read.  Returns (out [R, H, D], lse [R, H])."""
    r, h, d = q.shape
    bt = k_pool.shape[1]
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros((r, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((r, h), NEG_INF, dtype=torch.float32, device=q.device)
    for i, n in enumerate(lengths.tolist()):
        if n <= 0:
            continue
        pages = block_tables[i, :-(-n // bt)].long()
        k = k_pool[pages].reshape(-1, h, d)[:n].float()  # [L, H, D]
        v = v_pool[pages].reshape(-1, h, d)[:n].float()
        s = torch.einsum("hd,thd->ht", q[i].float(), k) * scale
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(dim=-1, keepdim=True)
        out[i] = torch.einsum("ht,thd->hd", e, v) / l
        lse[i] = (m + torch.log(l))[:, 0]
    return out, lse


def flash_block_update_split_reference(q, k, v, q_off, k_off, m, l, o, causal):
    """The plain mirror of the split update's fold order: per 16-row q tile,
    each warp's range of live 64-key tiles (``_update_warp_ranges``) folded
    tile by tile from a fresh state, then the carried state and the four
    warps' merged as the kernel merges them: m* = max, l* = sum l exp(m -
    m*), o* likewise, the carried state first.  A q tile with no live tile
    keeps its state as it is.  Returns the new (m, l, o); the inputs are
    left as they are.  For the tests: the CPU wrapper takes
    ``flash_block_update_reference``."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    m_new, l_new, o_new = m.clone(), l.clone(), o.clone()
    for q0, ranges in _update_warp_ranges(tq, tk, causal, q_off, k_off):
        if all(lo == hi for lo, hi in ranges):
            continue
        rows = slice(q0, q0 + SPLIT_ROWS)
        n = min(SPLIT_ROWS, tq - q0)
        states = [(m[:, rows, None], l[:, rows, None], o[:, rows])]
        for lo, hi in ranges:
            state = (torch.full((bh, n, 1), NEG_INF, dtype=torch.float32, device=q.device),
                     torch.zeros((bh, n, 1), dtype=torch.float32, device=q.device),
                     torch.zeros((bh, n, d), dtype=torch.float32, device=q.device))
            for t in range(lo, hi):
                keys = slice(t * SPLIT_TILE, min((t + 1) * SPLIT_TILE, tk))
                state = online_softmax_block_update(causal, scale, q[:, rows], k[:, keys],
                                                    v[:, keys], *state, q_off + q0,
                                                    k_off + t * SPLIT_TILE)
            states.append(state)
        ms, ls, accs = (torch.stack(x) for x in zip(*states))
        m_star = ms.amax(dim=0)
        f = torch.exp(ms - m_star)
        m_new[:, rows] = m_star[..., 0]
        l_new[:, rows] = (ls * f).sum(dim=0)[..., 0]
        o_new[:, rows] = (accs * f).sum(dim=0)
    return m_new, l_new, o_new


def flash_block_update_reference(q, k, v, q_off, k_off, m, l, o, causal):
    """The plain block update: the whole K/V block folded into each q-tile
    (``_q_tile``) of the state.  Returns the new (m, l, o); the inputs are
    left as they are."""
    tq, d = q.shape[1:]
    blk_q = _q_tile(tq, k.shape[1])
    scale = 1.0 / math.sqrt(d)
    m_new, l_new, o_new = torch.empty_like(m), torch.empty_like(l), torch.empty_like(o)
    for i in range(0, tq, blk_q):
        rows = slice(i, i + blk_q)
        mi, li, oi = online_softmax_block_update(
            causal, scale, q[:, rows], k, v, m[:, rows, None], l[:, rows, None], o[:, rows],
            q_off + i, k_off,
        )
        m_new[:, rows], l_new[:, rows], o_new[:, rows] = mi[..., 0], li[..., 0], oi
    return m_new, l_new, o_new


# ---------------------------------------------------------------------------
# kernels


def _check_qkv(q, k, v, dtypes=(torch.bfloat16,)) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in dtypes):
        raise TypeError(f"this flash kernel takes {' or '.join(map(str, dtypes))} q/k/v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected [BH, T, D] each, k and v alike")
    bh, _, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on BH or D")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash kernels take contiguous q, k, v")


def _check_device(*tensors) -> None:
    """What only the kernel needs: a head dim it was built for and
    16-byte-aligned storage (its copies move 16 bytes at a time)."""
    d = tensors[0].shape[-1]
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 up to {MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash kernels take 16-byte-aligned tensors")


_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# q, k, v, <state pointers>, bh, tq, tk, d, q_off, k_off, causal, scale, stream
_FORWARD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I64, _I64, _I, _F, _P]
_UPDATE_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I64, _I64, _I, _F, _P]
_ENTRIES = {  # source -> {entry: argtypes}
    "flash_attention": {
        "tpu_flash_forward_bf16": _FORWARD_ARGS,
        # the forward's, plus the f32 scratch after lse and n_splits before the stream
        "tpu_flash_forward_split_bf16": [*_FORWARD_ARGS[:5], _P, *_FORWARD_ARGS[5:13], _I, _P],
        "tpu_flash_block_update_bf16": _UPDATE_ARGS,
    },
    "flash_forward_sm90": {"tpu_flash_forward_wgmma_bf16": _FORWARD_ARGS},
    "flash_forward_f32": {
        "tpu_flash_forward_f32": _FORWARD_ARGS,
        # q, k_pool, v_pool, block_tables, lengths, out, lse, part, requests, heads, d,
        # block_tokens, width, max_splits, split_pages, scale, stream
        "tpu_flash_paged_f32": [_P] * 8 + [_I] * 7 + [_F, _P],
    },
    "flash_backward": {"tpu_flash_block_update_f32": _UPDATE_ARGS},
}


def _bind(source: str = "flash_attention") -> ctypes.CDLL:
    lib, _ = _build.library(source)
    for name, argtypes in _ENTRIES[source].items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


_n_sm: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _n_sm:
        _n_sm[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _n_sm[index]


def _on_card(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels run on cuda or cpu, not {q.device}")
    return True


def flash_attention_local(q, k, v, causal=True, block_k=1024, block_q=1024, q_off=0, k_off=0):
    """Flash attention in the merged layout ``[BH, T, D]`` (kernel B5), q/k/v
    all bf16 or all f32.  Returns (out [BH, Tq, D] in q's dtype, lse [BH, Tq]
    f32).
    ``q_off``/``k_off``: global sequence offsets (causal positions are
    ``q_off + row`` and ``k_off + col``).  On a card the kernel that
    ``_forward_plan`` picks for the call (launched on the current stream,
    not synchronized), which picks its own tiles; ``block_q``/``block_k``
    are kept for parity with the reference and honoured by the plain
    version (``_block_div``), which tensors on the CPU take."""
    _check_qkv(q, k, v, dtypes=FORWARD_DTYPES)
    if not _on_card(q):
        return flash_attention_local_reference(q, k, v, causal, block_k, block_q, q_off, k_off)
    _check_device(q, k, v)
    bh, tq, d = q.shape
    path, n_splits = _forward_plan(bh, tq, k.shape[1], d, causal, q_off, k_off,
                                   _sm_count(q.device), q.dtype)
    return _launch_forward(path, q, k, v, causal, q_off, k_off, n_splits)


def _flash_forward_on(path, q, k, v, causal=True, q_off=0, k_off=0, n_splits=None):
    """Run the forward on the named ``path`` (``wgmma``, ``split``, ``mma``
    or, for f32 q/k/v, ``f32``) at any shape that path takes, whatever the
    plan would pick: for holding each kernel against the plain version and
    timing one against another on the card.  ``n_splits`` defaults to the plan's
    sizing (``_split_count``).  The main path never calls it."""
    _check_qkv(q, k, v, dtypes=(torch.float32,) if path == "f32" else (torch.bfloat16,))
    if not _on_card(q):
        raise ValueError("_flash_forward_on launches a kernel: give it tensors on a card")
    _check_device(q, k, v)
    if path not in FORWARD_PATHS:
        raise ValueError(f"no forward path {path!r}: one of {sorted(FORWARD_PATHS)}")
    if n_splits is None:
        n_tiles = -(-_live_keys(q.shape[1], k.shape[1], causal, q_off, k_off) // SPLIT_TILE)
        n_splits = _split_count(q.shape[0], q.shape[1], n_tiles, _sm_count(q.device))
    return _launch_forward(path, q, k, v, causal, q_off, k_off, max(1, int(n_splits)))


def _launch_forward(path, q, k, v, causal, q_off, k_off, n_splits):
    """Launch the forward's ``path`` on checked tensors on a card; raises
    when the path does not take the shape or the launch fails."""
    global forward_launches
    bh, tq, d = q.shape
    tk = k.shape[1]
    if path == "wgmma" and d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the wgmma kernel takes {WGMMA_HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    common = (bh, tq, tk, d, int(q_off), int(k_off), int(bool(causal)), 1.0 / math.sqrt(d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
        if path == "f32":
            rc = _bind("flash_forward_f32").tpu_flash_forward_f32(*ptrs, *common, stream)
        elif path == "wgmma":
            rc = _bind("flash_forward_sm90").tpu_flash_forward_wgmma_bf16(*ptrs, *common, stream)
        elif path == "split":
            # one partial (m, l, acc[D]) per (split, bh, row), f32
            part = torch.empty(n_splits * bh * tq * (d + 2), dtype=torch.float32,
                               device=q.device)
            rc = _bind().tpu_flash_forward_split_bf16(*ptrs, part.data_ptr(), *common, n_splits,
                                                      stream)
        else:
            rc = _bind().tpu_flash_forward_bf16(*ptrs, *common, stream)
    if rc != 0:
        raise RuntimeError(f"flash forward kernel ({path}) launch failed: cudaError {rc}")
    forward_launches += 1
    forward_path_launches[path] += 1
    return out, lse


def _check_paged(q, k_pool, v_pool, block_tables, lengths) -> None:
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, the pools, the block tables and the lengths on "
                         f"{', '.join(str(t.device) for t in tensors)}: one device")
    if not all(t.dtype == torch.float32 for t in (q, k_pool, v_pool)):
        raise TypeError(f"the paged kernel takes float32 q and pools, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"block tables and lengths are int32, got {block_tables.dtype}, "
                        f"{lengths.dtype}")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}: expected [R, H, D] and two alike "
                         "[num_blocks, block_tokens, H, D]")
    r, h, d = q.shape
    if tuple(k_pool.shape[2:]) != (h, d):
        raise ValueError(f"q {tuple(q.shape)} and pools {tuple(k_pool.shape)} disagree on H or D")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the paged kernel takes at most {MAX_HEAD_DIM}")
    if block_tables.dim() != 2 or block_tables.shape[0] != r or tuple(lengths.shape) != (r,):
        raise ValueError(f"block tables {tuple(block_tables.shape)} and lengths "
                         f"{tuple(lengths.shape)}: expected [{r}, width] and [{r}]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the paged kernel takes contiguous tensors")


def flash_attention_paged(q, k_pool, v_pool, block_tables, lengths):
    """Decode attention over a paged KV pool (kernel B5's paged f32 entry):
    for each request r and head h, the query row ``q[r, h]`` against the
    request's first ``lengths[r]`` tokens, read in place from ``k_pool`` and
    ``v_pool`` ``[num_blocks, block_tokens, H, D]`` through its block table
    (token p at ``pool[block_tables[r, p // block_tokens], p % block_tokens]``).
    q and the pools f32, the tables ``[R, width]`` and lengths ``[R]`` int32,
    all contiguous on one device; D at most 128.  The entries of a request's
    live pages must name blocks of the pool (the engine's allocator's do);
    entries past them are never read.  Returns (out [R, H, D], lse [R, H]),
    f32; a request of length 0 gives out 0 and lse NEG_INF.

    On a card one launch for the whole batch (and a second, small one that
    merges the key splits when a row may have several: contexts past
    ``PAGED_SPLIT_PAGES`` pages), on the current stream, not synchronized;
    the lengths stay on the card (a length past ``width x block_tokens`` is
    cut there).  Tensors on the CPU take the plain version."""
    global forward_launches
    _check_paged(q, k_pool, v_pool, block_tables, lengths)
    if not _on_card(q):
        return flash_attention_paged_reference(q, k_pool, v_pool, block_tables, lengths)
    _check_device(q, k_pool, v_pool)
    r, h, d = q.shape
    bt, width = k_pool.shape[1], block_tables.shape[1]
    max_splits = _paged_split_count(width * bt, bt)
    out = torch.empty_like(q)
    lse = torch.empty((r, h), dtype=torch.float32, device=q.device)
    # one partial (acc[D], m, l) per (row, split), f32
    part = (torch.empty(r * h * max_splits * (d + 2), dtype=torch.float32, device=q.device)
            if max_splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bind("flash_forward_f32").tpu_flash_paged_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), lse.data_ptr(),
            part.data_ptr() if part is not None else None, r, h, d, bt, width, max_splits,
            PAGED_SPLIT_PAGES, 1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged flash forward kernel launch failed: cudaError {rc}")
    forward_launches += 1
    forward_path_launches["paged_f32"] += 1
    return out, lse


def flash_block_update(q, k, v, q_off, k_off, m, l, o, causal):
    """Fold one K/V block into the online-softmax state (kernel B3).

    q/k/v ``[BH, T, D]``, all bf16 or all f32; m, l ``[BH, Tq]`` and o
    ``[BH, Tq, D]`` f32; ``q_off``/``k_off`` are the blocks' global sequence
    offsets.  Updates m, l and o IN PLACE (the counterpart of the TPU
    kernel's ``input_output_aliases``) and returns them.  On a card the CUDA
    kernel of q's dtype (current stream, not synchronized); on the CPU the
    plain version, copied into the state."""
    global block_update_launches, block_update_f32_launches
    _check_qkv(q, k, v, dtypes=(torch.bfloat16, torch.float32))
    bh, tq, d = q.shape
    for name, t, shape in (("m", m, (bh, tq)), ("l", l, (bh, tq)), ("o", o, (bh, tq, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device} but q on {q.device}")
    if not _on_card(q):
        for t, new in zip((m, l, o), flash_block_update_reference(q, k, v, q_off, k_off,
                                                                  m, l, o, causal)):
            t.copy_(new)
        return m, l, o
    _check_device(q, k, v, m, l, o)
    f32 = q.dtype == torch.float32
    lib = _bind("flash_backward" if f32 else "flash_attention")
    entry = lib.tpu_flash_block_update_f32 if f32 else lib.tpu_flash_block_update_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
            bh, tq, k.shape[1], d, int(q_off), int(k_off), int(bool(causal)),
            1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash block update kernel launch failed: cudaError {rc}")
    if f32:
        block_update_f32_launches += 1
    else:
        block_update_launches += 1
    return m, l, o
