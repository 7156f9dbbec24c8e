"""Sustained serving on PyTorch: continuous batching over a paged KV cache.
Port of ``tpu_operator/workloads/serving.py``, same names, defaults, env
contract, result keys and snapshot layout.

- :class:`PagedKVCache` — the KV pool as fixed-size token blocks on the
  engine's device (two ``[num_blocks, block_tokens, heads, head_dim]`` f32
  tensors); the block tables, the free list, admission and defrag are the
  reference's plain Python.
- :class:`ToyLM` — the reference's seeded model: its numpy draws, as torch
  tensors on the device.  Every projection pads its rows to one fixed count
  per call site (``prefill_budget`` for prefill chunks, ``max_batch`` for
  the decode batch, the 8-row tail for the flash query), so each call site
  runs one GEMM shape and a row's result never depends on the rows beside
  it: the batch invariance that ``batching_ab`` asserts.  TF32 stays off.
- Decode attention over KV gathered from the pool on the device: ``dense``,
  the reference's length-masked einsum padded to ``max_batch`` x
  ``max_context`` (plain torch ops: it is no Pallas kernel there); ``flash``,
  per request, ``longctx.flash_attention_local`` (kernel B5's f32 path on a
  card) over the 8-row query tail and the KV zero-padded to a page multiple,
  with the reference's dense attend for a context shorter than the tail
  (counted in ``ServingEngine.dense_tail_attends``).  A decode step moves no
  KV across PCIe; it syncs with the host once, for the new token ids.
- :class:`PoissonTraffic`, :func:`serve` (the replica main loop, which
  checkpoints the whole serving state through ``workloads/checkpoint.py`` on
  the migrate signal and exits 0), :func:`batching_ab` (sequential vs
  continuous batching on the same request set) and :func:`quick_check`
  (the ``serving`` check).

Snapshots hold numpy copies of the pool under the reference's names
``kv_k`` and ``kv_v`` and its ``extra`` layout, so a snapshot written by
either package restores into the other.

Env contract: ``TPU_SERVE_RATE`` / ``TPU_SERVE_SECONDS`` /
``TPU_SERVE_SEED`` / ``TPU_SERVE_BLOCKS`` / ``TPU_SERVE_BLOCK_TOKENS`` /
``TPU_SERVE_MAX_BATCH`` / ``TPU_SERVE_PREFILL_BUDGET`` /
``TPU_SERVE_PROMPT_TOKENS`` / ``TPU_SERVE_NEW_TOKENS`` /
``TPU_SERVE_NAME`` / ``TPU_SERVE_STEP_INTERVAL_S`` plus the shared
``TPU_CKPT_DIR`` / ``TPU_MIGRATE_SIGNAL_FILE`` / ``TPU_JOB_RESULT_FILE``,
and ``TORCH_DEVICE`` (the card unless ``cpu`` is asked for).
"""

from __future__ import annotations

import heapq
import math
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from tpu_operator_torch import consts
from tpu_operator_torch.obs import flight
from tpu_operator_torch.obs import profile as obs_profile
from tpu_operator_torch.workloads import checkpoint as ckpt_api

# environment contract
RATE_ENV = "TPU_SERVE_RATE"
SECONDS_ENV = "TPU_SERVE_SECONDS"
SEED_ENV = "TPU_SERVE_SEED"
BLOCKS_ENV = "TPU_SERVE_BLOCKS"
BLOCK_TOKENS_ENV = "TPU_SERVE_BLOCK_TOKENS"
MAX_BATCH_ENV = "TPU_SERVE_MAX_BATCH"
PREFILL_BUDGET_ENV = "TPU_SERVE_PREFILL_BUDGET"
PROMPT_TOKENS_ENV = "TPU_SERVE_PROMPT_TOKENS"
NEW_TOKENS_ENV = "TPU_SERVE_NEW_TOKENS"
NAME_ENV = "TPU_SERVE_NAME"
STEP_INTERVAL_ENV = "TPU_SERVE_STEP_INTERVAL_S"

# request states
QUEUED = "queued"
PREFILL = "prefill"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"

# rolling-stat window sizes (samples, not seconds)
_ROLLING_SAMPLES = 512
_RATE_WINDOW_S = 5.0
# minimum evidence span before a rolling rate is reported
_RATE_MIN_SPAN_S = 0.5

FLASH_TAIL = 8  # query rows of the flash attend: the reference's decode tail
NEG_INF = -1e30


def _percentile(values: list, frac: float) -> float:
    """Index percentile over an ASCENDING list (0 when empty)."""
    if not values:
        return 0.0
    return float(values[min(len(values) - 1, int(frac * len(values)))])


class ServingError(Exception):
    """A request the engine cannot ever serve (oversize, bad shape)."""


# ---------------------------------------------------------------------------
# Paged KV cache.


class PagedKVCache:
    """Fixed-size-block KV pool shared by every in-flight request.

    K and V live as ``[num_blocks, block_tokens, heads, head_dim]`` tensors
    on ``device``; a request owns an ordered *block table* and its logical
    token ``p`` lives at ``(table[p // block_tokens], p % block_tokens)``.
    Allocation pops from a min-heap free list: the check and the take are
    one synchronous operation."""

    def __init__(
        self,
        num_blocks: int,
        block_tokens: int,
        heads: int,
        head_dim: int,
        dtype=torch.float32,
        device=None,
    ):
        if num_blocks <= 0 or block_tokens <= 0:
            raise ServingError("num_blocks and block_tokens must be positive")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.heads = heads
        self.head_dim = head_dim
        self.device = torch.device(device or "cpu")
        self.k = torch.zeros((num_blocks, block_tokens, heads, head_dim), dtype=dtype,
                             device=self.device)
        self.v = torch.zeros_like(self.k)
        self._free: list = list(range(num_blocks))
        self._free_set: set = set(self._free)
        self.alloc_failures = 0

    # -- allocation ----------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for_tokens(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_tokens))

    def try_alloc(self, n: int) -> Optional[list]:
        """``n`` blocks, or None when the pool cannot satisfy the request."""
        if n <= 0:
            raise ServingError(f"alloc of {n} blocks")
        if len(self._free) < n:
            self.alloc_failures += 1
            return None
        blocks = [heapq.heappop(self._free) for _ in range(n)]
        self._free_set.difference_update(blocks)
        return blocks

    def free(self, blocks: list) -> None:
        for b in blocks:
            if b in self._free_set or not (0 <= b < self.num_blocks):
                raise ServingError(f"double-free of KV block {b}")
            self._free_set.add(b)
            heapq.heappush(self._free, b)

    def high_water(self) -> int:
        """Highest used block id + 1 (0 when idle)."""
        used = set(range(self.num_blocks)) - self._free_set
        return (max(used) + 1) if used else 0

    def defrag(self, tables: dict) -> int:
        """Compact live blocks into the lowest-numbered free slots,
        rewriting the given block tables in place; returns moves made."""
        moves = 0
        for table in tables.values():
            for i, src in enumerate(table):
                if not self._free or self._free[0] >= src:
                    continue  # heap root IS the min: nothing lower is free
                dst = heapq.heappop(self._free)
                self._free_set.discard(dst)
                self.k[dst] = self.k[src]
                self.v[dst] = self.v[src]
                table[i] = dst
                self._free_set.add(src)
                heapq.heappush(self._free, src)
                moves += 1
        return moves

    # -- token I/O -----------------------------------------------------
    def _slots(self, table: list, start: int, n: int) -> torch.Tensor:
        """Flat pool rows (``block * block_tokens + slot``) of logical
        positions ``start .. start + n - 1``."""
        bt = self.block_tokens
        rows = [table[p // bt] * bt + p % bt for p in range(start, start + n)]
        return torch.tensor(rows, dtype=torch.long).to(self.device, non_blocking=True)

    def write_tokens(self, table: list, start: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Scatter ``k``/``v`` (``[T, heads, head_dim]``) for logical
        positions ``start .. start+T-1`` into the request's blocks."""
        rows = self._slots(table, start, k.shape[0])
        flat = (self.num_blocks * self.block_tokens, self.heads, self.head_dim)
        self.k.view(flat).index_copy_(0, rows, k.to(self.k.dtype))
        self.v.view(flat).index_copy_(0, rows, v.to(self.v.dtype))

    def gather(self, table: list, length: int, pad_to: Optional[int] = None) -> tuple:
        """Contiguous ``[pad_to, heads, head_dim]`` K and V for the first
        ``length`` logical tokens (zero-padded past them)."""
        pad_to = length if pad_to is None else pad_to
        out_k = torch.zeros((pad_to, self.heads, self.head_dim), dtype=self.k.dtype,
                            device=self.device)
        out_v = torch.zeros_like(out_k)
        if length:
            rows = self._slots(table, 0, length)
            flat = (self.num_blocks * self.block_tokens, self.heads, self.head_dim)
            out_k[:length] = self.k.view(flat)[rows]
            out_v[:length] = self.v.view(flat)[rows]
        return out_k, out_v

    # -- invariants ----------------------------------------------------
    def check_integrity(self, tables: dict) -> None:
        """Every live table disjoint from every other and from the free
        list, and together they account for the whole pool."""
        seen: dict = {}
        for rid, table in tables.items():
            for b in table:
                if b in seen:
                    raise ServingError(
                        f"KV block {b} double-allocated: {seen[b]} and {rid}"
                    )
                if b in self._free_set:
                    raise ServingError(
                        f"KV block {b} owned by {rid} AND on the free list"
                    )
                seen[b] = rid
        if len(self._free) != len(self._free_set):
            raise ServingError("free list/set diverged")
        if len(seen) + len(self._free) != self.num_blocks:
            raise ServingError(
                f"pool accounting broken: {len(seen)} owned + "
                f"{len(self._free)} free != {self.num_blocks}"
            )


# ---------------------------------------------------------------------------
# Toy deterministic LM: the reference's seeded weights, on the device.


def _toylm_arrays(vocab: int, heads: int, head_dim: int, max_context: int, seed: int) -> dict:
    """The reference's numpy draws (``serving.py:300-352``), in its order."""
    d = heads * head_dim
    rng = np.random.default_rng(seed)
    scale = 1.0 / math.sqrt(d)
    arrays = {
        "emb": (rng.standard_normal((vocab, d)) * 0.5).astype(np.float32),
        "wq": (rng.standard_normal((d, d)) * scale).astype(np.float32),
        "wk": (rng.standard_normal((d, d)) * scale).astype(np.float32),
        "wv": (rng.standard_normal((d, d)) * scale).astype(np.float32),
        "wu": (rng.standard_normal((d, vocab)) * scale).astype(np.float32),
    }
    # sinusoidal positions: KV must depend on position or the cache would be
    # content-addressable and the paging untestable
    pos = np.arange(max_context)[:, None]
    freq = np.exp(-np.arange(0, d, 2) * (math.log(10000.0) / d))[None, :]
    table = np.zeros((max_context, d), np.float32)
    table[:, 0::2] = np.sin(pos * freq)
    table[:, 1::2] = np.cos(pos * freq)
    arrays["pos"] = table
    return arrays


class ToyLM:
    """Per-position Q/K/V, causal attention over the cache, greedy next
    token; seed-reproducible so checkpoint/restore and batch invariance are
    bit-checkable."""

    WEIGHTS = ("emb", "wq", "wk", "wv", "wu", "pos")

    def __init__(
        self,
        vocab: int = 128,
        heads: int = 2,
        head_dim: int = 16,
        max_context: int = 256,
        seed: int = 0,
        device=None,
        arrays: Optional[dict] = None,
    ):
        self.vocab = vocab
        self.heads = heads
        self.head_dim = head_dim
        self.max_context = max_context
        self.seed = seed
        self.device = torch.device(device or "cpu")
        if arrays is None:
            arrays = _toylm_arrays(vocab, heads, head_dim, max_context, seed)
        for name in self.WEIGHTS:
            setattr(self, name, torch.as_tensor(np.asarray(arrays[name], np.float32))
                    .to(self.device))

    def _x(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return self.emb[tokens] + self.pos[positions]

    def qkv(self, tokens, positions, rows: Optional[int] = None) -> tuple:
        """``[T, heads, head_dim]`` Q, K, V for the given token ids at the
        given positions.  ``rows``: run the projections on that many rows
        (the extra ones token 0 at position 0, dropped after), so that one
        call site always runs one GEMM shape."""
        tokens = [int(t) for t in tokens]
        positions = [int(p) for p in positions]
        n = len(tokens)
        pad = max(0, (rows or n) - n)
        ids = torch.tensor([tokens + [0] * pad, positions + [0] * pad], dtype=torch.long)
        ids = ids.to(self.device, non_blocking=True)
        x = self._x(ids[0], ids[1])
        shape = (x.shape[0], self.heads, self.head_dim)
        return tuple((x @ w).reshape(shape)[:n] for w in (self.wq, self.wk, self.wv))

    def next_token(self, attended: torch.Tensor) -> int:
        """Greedy decode from one position's attended output
        (``[heads, head_dim]``)."""
        logits = attended.reshape(-1) @ self.wu
        return int(torch.argmax(logits))


def toylm_from_numpy(model, device=None) -> ToyLM:
    """A port :class:`ToyLM` carrying the weights of a model that holds them
    as numpy arrays (the reference's), bit for bit."""
    return ToyLM(vocab=model.vocab, heads=model.heads, head_dim=model.head_dim,
                 max_context=model.max_context, seed=model.seed, device=device,
                 arrays={name: getattr(model, name) for name in ToyLM.WEIGHTS})


def dense_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """The reference's length-masked decode attention (``serving.py:355-380``):
    q ``[B, H, D]`` against gathered KV ``[B, C, H, D]`` with per-row valid
    lengths; rows are independent."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,bchd->bhc", q, k) * scale
    mask = torch.arange(k.shape[1], device=q.device)[None, None, :] < lengths[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask, w, 0.0)
    return torch.einsum("bhc,bchd->bhd", w, v)


# ---------------------------------------------------------------------------
# Requests and traffic.


@dataclass
class Request:
    rid: str
    prompt: list
    max_new_tokens: int
    arrival: float
    state: str = QUEUED
    blocks: list = field(default_factory=list)
    prefilled: int = 0
    tokens: list = field(default_factory=list)
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    done_at: Optional[float] = None
    tpot_samples: list = field(default_factory=list)

    def __post_init__(self):
        if not self.tokens:
            self.tokens = list(self.prompt)

    @property
    def generated(self) -> int:
        return len(self.tokens) - len(self.prompt)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    def to_snapshot(self) -> dict:
        return {
            "rid": self.rid,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "arrival": self.arrival,
            "state": self.state,
            "blocks": list(self.blocks),
            "prefilled": self.prefilled,
            "tokens": list(self.tokens),
            "first_token_at": self.first_token_at,
            "last_token_at": self.last_token_at,
            "tpot_samples": list(self.tpot_samples),
        }

    @classmethod
    def from_snapshot(cls, data: dict) -> "Request":
        return cls(
            rid=data["rid"],
            prompt=list(data["prompt"]),
            max_new_tokens=int(data["max_new_tokens"]),
            arrival=float(data["arrival"]),
            state=data["state"],
            blocks=list(data["blocks"]),
            prefilled=int(data["prefilled"]),
            tokens=list(data["tokens"]),
            first_token_at=data.get("first_token_at"),
            last_token_at=data.get("last_token_at"),
            tpot_samples=list(data.get("tpot_samples") or []),
        )


class PoissonTraffic:
    """Seeded open-loop arrivals: exponential gaps at ``rate`` requests/s,
    uniform prompt/new-token draws; the generator state (RNG bit state,
    arrival cursor, id counter) rides the serving checkpoint."""

    def __init__(
        self,
        rate: float,
        prompt_tokens: tuple = (24, 64),
        new_tokens: tuple = (12, 32),
        vocab: int = 128,
        seed: int = 0,
        prefix: str = "req",
    ):
        self.rate = rate
        self.prompt_tokens = prompt_tokens
        self.new_tokens = new_tokens
        self.vocab = vocab
        self.prefix = prefix
        self.rng = np.random.default_rng(seed)
        self.next_id = 0
        self.next_at = self._gap()

    def _gap(self) -> float:
        if self.rate <= 0:
            return float("inf")
        return float(self.rng.exponential(1.0 / self.rate))

    def _mint(self, arrival: float) -> Request:
        plo, phi = self.prompt_tokens
        nlo, nhi = self.new_tokens
        prompt_len = int(self.rng.integers(plo, phi + 1))
        new = int(self.rng.integers(nlo, nhi + 1))
        prompt = [int(t) for t in self.rng.integers(0, self.vocab, prompt_len)]
        req = Request(
            rid=f"{self.prefix}-{self.next_id}",
            prompt=prompt,
            max_new_tokens=new,
            arrival=arrival,
        )
        self.next_id += 1
        return req

    def due(self, now: float) -> list:
        if self.rate > 0 and self.next_at == float("inf"):
            # stream re-enabled after a rate<=0 quiesce: restart the arrival
            # schedule from the caller's clock, not from zero
            self.next_at = now + self._gap()
        out = []
        while self.next_at <= now:
            out.append(self._mint(self.next_at))
            self.next_at += self._gap()
        return out

    def state(self) -> dict:
        return {
            "rate": self.rate,
            "next_id": self.next_id,
            "next_at": self.next_at,
            "rng": self.rng.bit_generator.state,
        }

    def restore(self, state: dict) -> None:
        self.next_id = int(state["next_id"])
        self.next_at = float(state["next_at"])
        self.rng.bit_generator.state = state["rng"]


# ---------------------------------------------------------------------------
# The engine.


@dataclass
class ServeConfig:
    vocab: int = 128
    heads: int = 2
    head_dim: int = 16
    num_blocks: int = 96
    block_tokens: int = 16
    max_batch: int = 8
    max_context: int = 128
    prefill_budget: int = 64
    # admission width: continuous batching admits up to max_batch; the
    # sequential baseline admits ONE request at a time (same shapes,
    # different scheduling: the only variable in the A/B)
    admit_limit: int = 0  # 0 = max_batch
    attend: str = "dense"  # dense | flash (flash = kernel B5)
    model_seed: int = 0
    name: str = "serving"
    device: Optional[str] = None  # None: workloads.resolve_device()

    def __post_init__(self):
        if self.max_context % self.block_tokens:
            raise ServingError("max_context must be a block_tokens multiple")

    @property
    def admission_width(self) -> int:
        return self.admit_limit or self.max_batch


class ServingEngine:
    """Iteration-level scheduler over one :class:`PagedKVCache`."""

    def __init__(self, cfg: ServeConfig, model: Optional[ToyLM] = None):
        from tpu_operator_torch.workloads import resolve_device

        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # the products must be full f32: tokens come from an argmax
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model or ToyLM(
            vocab=cfg.vocab, heads=cfg.heads, head_dim=cfg.head_dim,
            max_context=cfg.max_context, seed=cfg.model_seed, device=self.device,
        )
        self.cache = PagedKVCache(
            cfg.num_blocks, cfg.block_tokens, cfg.heads, cfg.head_dim, device=self.device,
        )
        self.queued: deque = deque()
        self.prefilling: list = []
        self.running: list = []
        self.steps = 0
        self.tokens_generated = 0
        self.requests_completed = 0
        self.requests_rejected = 0
        self.requests_cancelled = 0
        # flash attends that took the dense path: a context shorter than the
        # 8-row query tail (the reference's shape rule)
        self.dense_tail_attends = 0
        self._ttft: deque = deque(maxlen=_ROLLING_SAMPLES)
        self._tpot: deque = deque(maxlen=_ROLLING_SAMPLES)
        self._token_times: deque = deque(maxlen=4096)
        self._completions: list = []

    # -- submission ----------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request; False (counted) when it can never fit: over the
        context bound or over the whole pool's block count."""
        total = len(req.prompt) + req.max_new_tokens
        if (
            not req.prompt
            or total > self.cfg.max_context
            or self.cache.blocks_for_tokens(total) > self.cache.num_blocks
        ):
            self.requests_rejected += 1
            return False
        self.queued.append(req)
        return True

    def cancel(self, rid: str) -> bool:
        """Client went away: drop the request wherever it stands and free
        its blocks immediately."""
        for req in list(self.queued):
            if req.rid == rid:
                self.queued.remove(req)
                req.state = CANCELLED
                self.requests_cancelled += 1
                return True
        for bucket in (self.prefilling, self.running):
            for req in bucket:
                if req.rid == rid:
                    bucket.remove(req)
                    self._release(req, CANCELLED)
                    self.requests_cancelled += 1
                    return True
        return False

    def _release(self, req: Request, state: str) -> None:
        if req.blocks:
            self.cache.free(req.blocks)
            req.blocks = []
        req.state = state

    # -- scheduling ----------------------------------------------------
    def _blocks_needed(self, req: Request) -> int:
        return self.cache.blocks_for_tokens(len(req.prompt) + req.max_new_tokens)

    def _admit(self) -> int:
        """FIFO capacity-based admission: a queued request joins only when
        its worst-case block need allocates and the batch has a seat."""
        admitted = 0
        width = self.cfg.admission_width
        while self.queued:
            active = len(self.prefilling) + len(self.running)
            if active >= min(width, self.cfg.max_batch):
                break
            req = self.queued[0]
            blocks = self.cache.try_alloc(self._blocks_needed(req))
            if blocks is None:
                break  # FIFO: no overtaking past a starved head
            self.queued.popleft()
            req.blocks = blocks
            req.state = PREFILL
            req.prefilled = 0
            self.prefilling.append(req)
            admitted += 1
        return admitted

    def _prefill(self) -> int:
        """Advance prefill across admitted requests under the per-step token
        budget (chunked)."""
        budget = self.cfg.prefill_budget
        done: list = []
        for req in self.prefilling:
            if budget <= 0:
                break
            take = min(budget, len(req.prompt) - req.prefilled)
            if take > 0:
                start = req.prefilled
                _, k, v = self.model.qkv(req.prompt[start:start + take],
                                         range(start, start + take),
                                         rows=self.cfg.prefill_budget)
                self.cache.write_tokens(req.blocks, start, k, v)
                req.prefilled += take
                budget -= take
            if req.prefilled >= len(req.prompt):
                done.append(req)
        for req in done:
            self.prefilling.remove(req)
            req.state = RUNNING
            self.running.append(req)
        return len(done)

    # -- decode --------------------------------------------------------
    def _attend_dense(self, reqs: list, qs: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, C = cfg.max_batch, cfg.max_context
        k = torch.zeros((B, C, cfg.heads, cfg.head_dim), device=self.device)
        v = torch.zeros_like(k)
        q = torch.zeros((B, cfg.heads, cfg.head_dim), device=self.device)
        lengths = [0] * B
        for i, req in enumerate(reqs):
            length = len(req.tokens)
            k[i], v[i] = self.cache.gather(req.blocks, length, pad_to=C)
            lengths[i] = length
        q[:len(reqs)] = qs
        lengths = torch.tensor(lengths, dtype=torch.int32).to(self.device, non_blocking=True)
        return dense_attend(q, k, v, lengths)[:len(reqs)]

    def _attend_flash(self, reqs: list, qs: torch.Tensor) -> torch.Tensor:
        """Per request, ``longctx.flash_attention_local`` (kernel B5's f32
        path on a card) with the 8-row query tail over gathered KV
        zero-padded to a block multiple: padded keys sit past every query,
        so causal masking drops them."""
        from tpu_operator_torch.workloads import longctx

        tail = FLASH_TAIL
        cfg = self.cfg
        out = torch.zeros((len(reqs), cfg.heads, cfg.head_dim), device=self.device)
        for i, req in enumerate(reqs):
            length = len(req.tokens)
            if length < tail:
                # a context shorter than the query tail: the dense attend
                self.dense_tail_attends += 1
                out[i] = self._attend_dense([req], qs[i:i + 1])[0]
                continue
            pad = cfg.block_tokens * math.ceil(length / cfg.block_tokens)
            gk, gv = self.cache.gather(req.blocks, length, pad_to=pad)
            # [T, H, D] -> merged [BH=H, T, D]
            km = gk.transpose(0, 1).contiguous()
            vm = gv.transpose(0, 1).contiguous()
            qt, _, _ = self.model.qkv(req.tokens[length - tail:length],
                                      range(length - tail, length), rows=tail)
            qm = qt.transpose(0, 1).contiguous()
            o, _ = longctx.flash_attention_local(
                qm, km, vm, causal=True,
                block_k=cfg.block_tokens, block_q=tail,
                q_off=length - tail,
            )
            out[i] = o[:, -1, :]
        return out

    def _decode(self, now: float) -> int:
        reqs = self.running[: self.cfg.max_batch]
        if not reqs:
            return 0
        B = self.cfg.max_batch
        # q from each request's last token at its position: one projection
        # for the whole batch, padded to max_batch rows
        qs, _, _ = self.model.qkv([req.tokens[-1] for req in reqs],
                                  [len(req.tokens) - 1 for req in reqs], rows=B)
        if self.cfg.attend == "flash":
            attended = self._attend_flash(reqs, qs)
        else:
            attended = self._attend_dense(reqs, qs)
        # greedy next tokens for the whole batch in one projection (padded
        # to max_batch rows), and the one host sync of the step
        rows = torch.zeros((B, attended[0].numel()), device=self.device)
        rows[:len(reqs)] = attended.reshape(len(reqs), -1)
        next_tokens = torch.argmax(rows @ self.model.wu, dim=-1)[:len(reqs)].tolist()
        finished: list = []
        continuing: list = []
        for i, req in enumerate(reqs):
            token = int(next_tokens[i])
            pos = len(req.tokens)
            req.tokens.append(token)
            self.tokens_generated += 1
            if req.first_token_at is None:
                req.first_token_at = now
                self._ttft.append(req.ttft_s or 0.0)
            else:
                interval = now - req.last_token_at
                req.tpot_samples.append(interval)
                self._tpot.append(interval)
            req.last_token_at = now
            if req.generated >= req.max_new_tokens:
                finished.append(req)
            else:
                continuing.append((req, token, pos))
        if continuing:
            # the new tokens' KV joins the cache (block seats were reserved
            # at admission); one projection, scattered per request
            _, ks, vs = self.model.qkv([t for _, t, _ in continuing],
                                       [p for _, _, p in continuing], rows=B)
            for i, (req, _, pos) in enumerate(continuing):
                self.cache.write_tokens(req.blocks, pos, ks[i:i + 1], vs[i:i + 1])
        self._token_times.append((now, len(reqs)))
        for req in finished:
            self.running.remove(req)
            req.done_at = now
            self._completions.append({
                "rid": req.rid,
                "tokens": req.generated,
                "ttft_s": req.ttft_s,
                "tpot_mean_s": (
                    sum(req.tpot_samples) / len(req.tpot_samples)
                    if req.tpot_samples else 0.0
                ),
            })
            self._release(req, DONE)
            self.requests_completed += 1
        return len(finished)

    # -- the iteration -------------------------------------------------
    def step(self, now: Optional[float] = None) -> dict:
        """One continuous-batching iteration: admit -> prefill -> decode
        (retirement happens at the end of the previous decode, so its blocks
        serve this step's admissions)."""
        now = time.monotonic() if now is None else now
        self.steps += 1
        admitted = self._admit()
        prefilled = self._prefill()
        finished = self._decode(now)
        return {
            "now": now,
            "admitted": admitted,
            "prefill_completed": prefilled,
            "finished": finished,
            "queue_depth": len(self.queued),
            "batch": len(self.running),
            "prefilling": len(self.prefilling),
            "kv_blocks_free": self.cache.free_count,
        }

    @property
    def active(self) -> int:
        return len(self.queued) + len(self.prefilling) + len(self.running)

    def block_tables(self) -> dict:
        return {
            req.rid: req.blocks
            for req in (*self.prefilling, *self.running)
            if req.blocks
        }

    def check_integrity(self) -> None:
        self.cache.check_integrity(self.block_tables())

    # -- rolling telemetry --------------------------------------------
    @staticmethod
    def _p99(samples) -> float:
        return _percentile(sorted(samples), 0.99)

    def tokens_per_sec(self, now: Optional[float] = None) -> Optional[float]:
        """Rolling decode rate, or None while the window holds too little
        evidence to divide by; 0.0 means a live batch produced nothing all
        window."""
        now = time.monotonic() if now is None else now
        cutoff = now - _RATE_WINDOW_S
        recent = [(ts, n) for ts, n in self._token_times if ts >= cutoff]
        if not recent:
            return 0.0 if self.running else None
        span = now - recent[0][0]
        if span < _RATE_MIN_SPAN_S:
            return None
        return sum(n for _, n in recent) / span

    def telemetry(self, now: Optional[float] = None) -> dict:
        """The flight-sample metric map (the ``tpu_workload_serving_*``
        counters); the throughput gauge goes dark without evidence."""
        out = {
            "serve_ttft_p99_s": round(self._p99(self._ttft), 6),
            "serve_tpot_p99_s": round(self._p99(self._tpot), 6),
            "serve_queue_depth": float(len(self.queued)),
            "serve_batch_size": float(len(self.running)),
            "serve_kv_blocks_free": float(self.cache.free_count),
            "serve_requests_completed": float(self.requests_completed),
            "serve_requests_rejected": float(self.requests_rejected),
            "serve_decoded_tokens": float(self.tokens_generated),
        }
        tps = self.tokens_per_sec(now)
        if tps is not None:
            out["serve_tokens_per_sec"] = round(tps, 3)
        return out

    def completions(self) -> list:
        return list(self._completions)

    # -- checkpoint/restore --------------------------------------------
    def snapshot(self) -> tuple:
        """(arrays, extra) for ``checkpoint.save_checkpoint``: the KV pool as
        numpy copies under the reference's names, the request and traffic
        bookkeeping as its JSON ``extra``."""
        arrays = {"kv_k": self.cache.k.cpu().numpy(), "kv_v": self.cache.v.cpu().numpy()}
        extra = {
            "config": {
                "vocab": self.cfg.vocab,
                "heads": self.cfg.heads,
                "head_dim": self.cfg.head_dim,
                "num_blocks": self.cfg.num_blocks,
                "block_tokens": self.cfg.block_tokens,
                "max_context": self.cfg.max_context,
                "model_seed": self.cfg.model_seed,
            },
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "requests_cancelled": self.requests_cancelled,
            "requests": [
                req.to_snapshot()
                for req in (*self.queued, *self.prefilling, *self.running)
            ],
            # lifetime latency evidence rides too
            "completions": list(self._completions),
            "ttft_samples": [float(v) for v in self._ttft],
            "tpot_samples": [float(v) for v in self._tpot],
        }
        return arrays, extra

    @classmethod
    def from_snapshot(cls, cfg: ServeConfig, arrays: dict, extra: dict) -> "ServingEngine":
        saved = extra.get("config") or {}
        for key in ("heads", "head_dim", "num_blocks", "block_tokens",
                    "max_context", "vocab", "model_seed"):
            if saved.get(key) is not None and saved[key] != getattr(cfg, key):
                raise ServingError(
                    f"snapshot {key}={saved[key]} != config {getattr(cfg, key)}"
                )
        engine = cls(cfg)
        for name, pool in (("kv_k", engine.cache.k), ("kv_v", engine.cache.v)):
            pool.copy_(torch.as_tensor(np.asarray(arrays[name], np.float32)))
        engine.steps = int(extra.get("steps") or 0)
        engine.tokens_generated = int(extra.get("tokens_generated") or 0)
        engine.requests_completed = int(extra.get("requests_completed") or 0)
        engine.requests_rejected = int(extra.get("requests_rejected") or 0)
        engine.requests_cancelled = int(extra.get("requests_cancelled") or 0)
        engine._completions = list(extra.get("completions") or [])
        engine._ttft.extend(extra.get("ttft_samples") or [])
        engine._tpot.extend(extra.get("tpot_samples") or [])
        # reclaim the snapshot's block ownership from the fresh free list
        owned: list = []
        for entry in extra.get("requests") or []:
            req = Request.from_snapshot(entry)
            owned.extend(req.blocks)
            if req.state == QUEUED:
                engine.queued.append(req)
            elif req.state == PREFILL:
                engine.prefilling.append(req)
            elif req.state == RUNNING:
                engine.running.append(req)
        owned_set = set(owned)
        engine.cache._free = [b for b in engine.cache._free if b not in owned_set]
        heapq.heapify(engine.cache._free)
        engine.cache._free_set = set(engine.cache._free)
        engine.check_integrity()
        return engine


# ---------------------------------------------------------------------------
# The replica main loop (the serve soak's payload).


def serve(
    cfg: ServeConfig,
    traffic: PoissonTraffic,
    duration_s: float,
    ckpt_dir: str = "",
    sig: Optional[ckpt_api.MigrationSignal] = None,
    progress: Optional[Callable[[dict], None]] = None,
    step_interval_s: float = 0.01,
    clock: Callable[[], float] = time.monotonic,
) -> dict:
    """Real-time serving until ``duration_s`` of service elapse or the
    migration signal lands.  Elapsed service time is the clock: a restored
    replica picks up at the snapshot's elapsed point and serves the
    remainder, with the traffic cursor and every in-flight request intact."""
    sig = sig or ckpt_api.MigrationSignal()
    elapsed0 = 0.0
    resumed = False
    engine: Optional[ServingEngine] = None
    if ckpt_dir:
        snap = ckpt_api.load_checkpoint(ckpt_dir)
        if snap is not None:
            engine = ServingEngine.from_snapshot(cfg, snap.arrays, snap.extra)
            serve_state = snap.extra.get("serve") or {}
            elapsed0 = float(serve_state.get("elapsed_s") or 0.0)
            if serve_state.get("traffic"):
                traffic.restore(serve_state["traffic"])
            resumed = True
    if engine is None:
        engine = ServingEngine(cfg)
    if progress is not None:
        progress({
            "event": "restored" if resumed else "started",
            "elapsed_s": round(elapsed0, 3),
            "resumed_requests": engine.active if resumed else 0,
            "tokens_total": engine.tokens_generated,
        })

    t0 = clock()
    last_report = 0.0
    migrated_out = False

    def now_elapsed() -> float:
        return elapsed0 + (clock() - t0)

    while True:
        now = now_elapsed()
        if now >= duration_s and engine.active == 0:
            break
        if sig.requested():
            migrated_out = True
            break
        # admission from the traffic model is the host-input span, the
        # batched prefill + decode tick is compute
        timer = obs_profile.StepTimer()
        t_step0 = time.perf_counter()
        if now < duration_s:
            with timer.phase(obs_profile.PHASE_HOST_INPUT):
                for req in traffic.due(now):
                    engine.submit(req)
        with timer.phase(obs_profile.PHASE_COMPUTE):
            stats = engine.step(now)
        metrics = engine.telemetry(now)
        flight.record(cfg.name, "step", step=engine.steps, **metrics)
        flight.record_step(
            cfg.name, step_seq=engine.steps,
            wall_s=time.perf_counter() - t_step0, phases=timer.spans(),
        )
        if progress is not None and now - last_report >= 1.0:
            last_report = now
            progress({
                "event": "serving",
                "elapsed_s": round(now, 3),
                "tokens_total": engine.tokens_generated,
                "completed": engine.requests_completed,
                "queue_depth": stats["queue_depth"],
                "batch": stats["batch"],
                # optional: the throughput gauge goes dark while idle
                "tokens_per_sec": metrics.get("serve_tokens_per_sec", 0.0),
            })
        # pace the loop: decode-bound, not spin-bound
        spent = now_elapsed() - now
        if step_interval_s > spent:
            time.sleep(step_interval_s - spent)

    final_elapsed = now_elapsed()
    checkpointed = False
    if migrated_out and ckpt_dir:
        arrays, extra = engine.snapshot()
        extra["serve"] = {
            "elapsed_s": final_elapsed,
            "traffic": traffic.state(),
        }
        writer = ckpt_api.Checkpointer(ckpt_dir)
        writer.save(engine.steps, arrays, extra=extra, final=True)
        checkpointed = True
        if progress is not None:
            progress({
                "event": "checkpointed",
                "trigger": "migrate-signal",
                "step": engine.steps,
                "tokens_total": engine.tokens_generated,
                "in_flight": engine.active,
            })

    completions = engine.completions()
    tpots = sorted(c["tpot_mean_s"] for c in completions if c["tpot_mean_s"])
    ttfts = sorted(c["ttft_s"] for c in completions if c.get("ttft_s") is not None)
    return {
        # a drained replica that could not snapshot must not exit 0: the
        # coordinator reads exit 0 as checkpoint-complete
        "ok": checkpointed or not migrated_out,
        "resumed": resumed,
        "migrated_out": migrated_out,
        "checkpointed": checkpointed,
        "elapsed_s": round(final_elapsed, 3),
        "steps": engine.steps,
        "tokens_total": engine.tokens_generated,
        "requests_completed": engine.requests_completed,
        "requests_rejected": engine.requests_rejected,
        "in_flight_at_exit": engine.active,
        "tokens_per_sec": round(engine.tokens_generated / max(1e-6, final_elapsed), 3),
        "ttft_p50_s": round(_percentile(ttfts, 0.5), 6),
        "ttft_p99_s": round(_percentile(ttfts, 0.99), 6),
        "tpot_p50_s": round(_percentile(tpots, 0.5), 6),
        "tpot_p99_s": round(_percentile(tpots, 0.99), 6),
    }


# ---------------------------------------------------------------------------
# The acceptance A/B: continuous batching vs sequential scheduling.


def batching_ab(
    n_requests: int = 24,
    prompt_tokens: int = 48,
    new_tokens: int = 32,
    max_batch: int = 8,
    seed: int = 7,
    cfg: Optional[ServeConfig] = None,
    streams: Optional[dict] = None,
) -> dict:
    """The same seeded closed-loop request set (all arrive at t=0) through
    sequential one-request-at-a-time scheduling and continuous batching, at
    the same shapes (both pad to ``max_batch``).  Returns both runs'
    tokens/sec and per-request TPOT percentiles, and the batch-invariance
    verdict.  ``streams``, when given, receives the batched run's token
    streams by request id (to compare attend modes)."""
    base = cfg or ServeConfig(max_batch=max_batch)

    def _requests() -> list:
        rng = np.random.default_rng(seed)
        return [
            Request(
                rid=f"ab-{i}",
                prompt=[int(t) for t in rng.integers(0, base.vocab, prompt_tokens)],
                max_new_tokens=new_tokens,
                arrival=0.0,
            )
            for i in range(n_requests)
        ]

    def _run_streams(admit_limit: int) -> tuple:
        cfg_run = ServeConfig(
            vocab=base.vocab, heads=base.heads, head_dim=base.head_dim,
            num_blocks=base.num_blocks, block_tokens=base.block_tokens,
            max_batch=base.max_batch, max_context=base.max_context,
            prefill_budget=base.prefill_budget, admit_limit=admit_limit,
            attend=base.attend, model_seed=base.model_seed, device=base.device,
        )
        engine = ServingEngine(cfg_run)
        reqs = _requests()
        for req in reqs:
            assert engine.submit(req)
        t0 = time.perf_counter()
        guard = 0
        while engine.active and guard < 1_000_000:
            engine.step(time.perf_counter() - t0)
            guard += 1
        wall = max(1e-9, time.perf_counter() - t0)
        comps = engine.completions()
        tpots = sorted(c["tpot_mean_s"] for c in comps if c["tpot_mean_s"])
        return {
            "tokens": engine.tokens_generated,
            "wall_s": round(wall, 4),
            "tokens_per_sec": round(engine.tokens_generated / wall, 2),
            "completed": engine.requests_completed,
            "tpot_p50_s": _percentile(tpots, 0.5),
            "tpot_p99_s": _percentile(tpots, 0.99),
            "steps": engine.steps,
        }, {req.rid: req.tokens[len(req.prompt):] for req in reqs}

    # warm the attention path before timing either run, so a one-time cost
    # (the first cuBLAS call, a kernel library's load) lands in neither
    _run_streams(admit_limit=0)
    sequential, seq_streams = _run_streams(admit_limit=1)
    batched, batch_streams = _run_streams(admit_limit=0)
    if streams is not None:
        streams.update(batch_streams)
    identical = seq_streams == batch_streams
    speedup = (
        batched["tokens_per_sec"] / sequential["tokens_per_sec"]
        if sequential["tokens_per_sec"] else 0.0
    )
    return {
        "ok": bool(
            identical
            and sequential["completed"] == n_requests
            and batched["completed"] == n_requests
        ),
        "n_requests": n_requests,
        "prompt_tokens": prompt_tokens,
        "new_tokens": new_tokens,
        "max_batch": max_batch,
        "sequential": sequential,
        "batched": batched,
        "speedup": round(speedup, 3),
        "identical_outputs": identical,
    }


def quick_check(device=None, attend: str = "dense", streams: Optional[dict] = None) -> dict:
    """The validator's opt-in serving probe: a small closed-loop A/B;
    continuous batching must keep every request's output identical to
    sequential scheduling (``ok`` covers it), the speedup is reported.
    ``attend`` and ``streams`` as in :func:`batching_ab`."""
    from tpu_operator_torch.workloads import resolve_device

    cfg = ServeConfig(max_batch=8, attend=attend, device=device)
    result = batching_ab(n_requests=8, prompt_tokens=24, new_tokens=12, cfg=cfg,
                         streams=streams)
    result["check"] = "serving"
    result["backend"] = resolve_device(device).type
    result["ok"] = bool(result["identical_outputs"]) and result["ok"]
    return result


# ---------------------------------------------------------------------------
# Module main: the serve-soak replica payload.


def _int_range(env: str, default: tuple) -> tuple:
    raw = os.environ.get(env, "")
    if not raw:
        return default
    try:
        lo, _, hi = raw.partition(",")
        lo_i, hi_i = int(lo), int(hi or lo)
        return (lo_i, max(lo_i, hi_i))
    except ValueError:
        return default


def main() -> int:
    from tpu_operator_torch.validator import status as vstatus
    from tpu_operator_torch.workloads import resolve_device

    resolve_device()  # no card and no TORCH_DEVICE=cpu request: raise
    name = os.environ.get(NAME_ENV, "serving")
    cfg = ServeConfig(
        num_blocks=int(os.environ.get(BLOCKS_ENV, "96") or 96),
        block_tokens=int(os.environ.get(BLOCK_TOKENS_ENV, "16") or 16),
        max_batch=int(os.environ.get(MAX_BATCH_ENV, "8") or 8),
        prefill_budget=int(os.environ.get(PREFILL_BUDGET_ENV, "64") or 64),
        name=name,
    )
    traffic = PoissonTraffic(
        rate=float(os.environ.get(RATE_ENV, "3") or 3),
        prompt_tokens=_int_range(PROMPT_TOKENS_ENV, (24, 64)),
        new_tokens=_int_range(NEW_TOKENS_ENV, (12, 32)),
        vocab=cfg.vocab,
        seed=int(os.environ.get(SEED_ENV, "0") or 0),
        prefix=name,
    )
    duration = float(os.environ.get(SECONDS_ENV, "30") or 30)
    step_interval = float(os.environ.get(STEP_INTERVAL_ENV, "0.01") or 0.01)
    ckpt_dir = os.environ.get(consts.CKPT_DIR_ENV, "")
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
    result_file = os.environ.get("TPU_JOB_RESULT_FILE", "")

    def progress(event: dict) -> None:
        ckpt_api.emit(result_file, event)

    recorder = flight.recorder_for(vstatus.flight_record_path(name))
    with flight.activate(recorder):
        result = serve(
            cfg,
            traffic,
            duration_s=duration,
            ckpt_dir=ckpt_dir,
            progress=progress,
            step_interval_s=step_interval,
        )
        flight.record_result(name, result)
    progress({"event": "result", **result})
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
