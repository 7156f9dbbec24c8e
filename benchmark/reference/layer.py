"""The plain reference of the training probe's layer: one pre-norm
transformer layer (RMSNorm, causal multi-head attention, a ReLU MLP, no
biases, no positions) and its SGD steps on the mean square of its output,
written from the layer's equations in plain PyTorch at float32.

- h = bf16(x · rsqrt(mean(x²) + 1e-6)) of the bf16 input x: the layer's
  normalized input is bfloat16, then every product is float32;
- q, k, v = h·Wq, h·Wk, h·Wv split into heads; a = softmax(q·kᵀ/√d_head,
  causal)·v merged, then a·Wo; x_a = x + a·Wo;
- g = RMSNorm(x_a); y = relu(g·W1)·W2; out = x_a + y;
- loss = Σ out² / (batch · seq · d_model) over the whole global batch,
  and w ← w − lr·∂loss/∂w for each of Wq, Wk, Wv, Wo, W1, W2.

Attention runs a sequence at a time in blocks of query rows, each against
the keys it can see, with a backward that recomputes each block's
probabilities from the saved log-sum-exp, so it fits at 32768 tokens; the
gradients of the sequences add up.  With ``tf32`` every product, forward
and backward, takes its operands rounded to TF32 (10 mantissa bits, to
nearest) and sums in float32, as a TF32 tensor core does: the lower
precision the control uses, the same on the card and on the CPU."""

from __future__ import annotations

import contextlib
import math

import torch

LEAVES = ("wq", "wk", "wv", "wo", "w1", "w2")


@contextlib.contextmanager
def full_float32():
    """float32 products in full float32 (no TF32) while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return torch.matmul(g, to_tf32(b).transpose(-1, -2)), torch.matmul(
            to_tf32(a).transpose(-1, -2), g)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _Tf32Matmul.apply(a, b) if tf32 else torch.matmul(a, b)


def rms_normalize(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    x = x.to(dtype)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)


class CausalAttention(torch.autograd.Function):
    """softmax(q·kᵀ·scale, causal)·v of one sequence, q, k, v [H, S, D]
    float32, in blocks of ``rows`` queries."""

    @staticmethod
    def forward(ctx, q, k, v, rows: int, tf32: bool):
        heads, seq, d = q.shape
        scale = 1.0 / math.sqrt(d)
        out = torch.empty_like(q)
        lse = torch.empty((heads, seq), dtype=q.dtype, device=q.device)
        for i0 in range(0, seq, rows):
            i1 = min(seq, i0 + rows)
            s = mm(q[:, i0:i1], k[:, :i1].transpose(1, 2), tf32) * scale
            hidden = (torch.arange(i0, i1, device=q.device)[:, None]
                      < torch.arange(i1, device=q.device)[None, :])
            s.masked_fill_(hidden, float("-inf"))
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            total = p.sum(-1, keepdim=True)
            out[:, i0:i1] = mm(p, v[:, :i1], tf32) / total
            lse[:, i0:i1] = (m + torch.log(total)).squeeze(-1)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.rows, ctx.tf32 = rows, tf32
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        tf32 = ctx.tf32
        heads, seq, d = q.shape
        scale = 1.0 / math.sqrt(d)
        dout = dout.contiguous()
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (dout * out).sum(-1)  # [H, S]
        for i0 in range(0, seq, ctx.rows):
            i1 = min(seq, i0 + ctx.rows)
            s = mm(q[:, i0:i1], k[:, :i1].transpose(1, 2), tf32) * scale
            hidden = (torch.arange(i0, i1, device=q.device)[:, None]
                      < torch.arange(i1, device=q.device)[None, :])
            s.masked_fill_(hidden, float("-inf"))
            p = torch.exp(s - lse[:, i0:i1, None])
            do = dout[:, i0:i1]
            dv[:, :i1] += mm(p.transpose(1, 2), do, tf32)
            dp = mm(do, v[:, :i1].transpose(1, 2), tf32)
            ds = p * (dp - delta[:, i0:i1, None])
            dq[:, i0:i1] = mm(ds, k[:, :i1], tf32) * scale
            dk[:, :i1] += mm(ds.transpose(1, 2), q[:, i0:i1], tf32) * scale
        return dq, dk, dv, None, None


def sequence_loss(w: dict, x: torch.Tensor, heads: int, count: int, rows: int,
                  tf32: bool) -> torch.Tensor:
    """Σ out² / count of one sequence x [S, d] (bf16) through the layer, in
    the weights' dtype."""
    seq, d = x.shape
    hd = d // heads
    dtype = w["wq"].dtype
    h = rms_normalize(x).to(torch.bfloat16).to(dtype)

    def split(t):  # [S, d] -> [H, S, hd]
        return t.reshape(seq, heads, hd).transpose(0, 1).contiguous()

    q, k, v = (split(mm(h, w[name], tf32)) for name in ("wq", "wk", "wv"))
    a = CausalAttention.apply(q, k, v, rows, tf32).transpose(0, 1).reshape(seq, d)
    xa = x.to(dtype) + mm(a, w["wo"], tf32)
    y = mm(torch.relu(mm(rms_normalize(xa, dtype), w["w1"], tf32)), w["w2"], tf32)
    out = xa + y
    return out.square().sum() / count


def half_of(x: torch.Tensor) -> torch.Tensor:
    """A global batch with half of it left out: the first half of its
    sequences, or of its tokens when it holds one sequence (causal, so
    those tokens see nothing of the rest)."""
    return x[:x.shape[0] // 2] if x.shape[0] > 1 else x[:, :x.shape[1] // 2]


def loss_and_grads(w: dict, x: torch.Tensor, heads: int, rows: int, tf32: bool = False):
    """(loss, gradients) of the layer on the global batch x [B, S, d]."""
    count = x.shape[0] * x.shape[1] * x.shape[2]
    leaves = {name: w[name].detach().requires_grad_() for name in LEAVES}
    grads = {name: torch.zeros_like(w[name]) for name in LEAVES}
    loss = 0.0
    for b in range(x.shape[0]):
        part = sequence_loss(leaves, x[b], heads, count, rows, tf32)
        for name, g in zip(LEAVES, torch.autograd.grad(part, [leaves[n] for n in LEAVES])):
            grads[name] += g
        loss += float(part.detach())
    return loss, grads


def train(weights: dict, batches: list, heads: int, lr: float, steps: int = 3,
          tf32: bool = False, half: bool = False, rows: int = 512,
          dtype=torch.float32) -> dict:
    """``steps`` SGD steps from ``weights`` (full, float32), step t on
    ``batches[t]`` (global [B, S, d], bf16).  Returns the readings the
    program is held to: each step's loss, each leaf's first gradient norm,
    each leaf's change norm after the last step.  ``half`` leaves half of
    each batch out (a fault the tests and the calibration plant);
    ``dtype`` float64 makes a second witness of the float32 reference."""
    w = {name: weights[name].to(dtype).clone() for name in LEAVES}
    losses, grad_norms = [], {}
    with full_float32():
        for t in range(steps):
            x = half_of(batches[t]) if half else batches[t]
            loss, grads = loss_and_grads(w, x, heads, rows, tf32)
            losses.append(loss)
            if t == 0:
                grad_norms = {name: float(g.double().norm()) for name, g in grads.items()}
            w = {name: w[name] - lr * grads[name] for name in LEAVES}
            del grads
    change_norms = {name: float((w[name] - weights[name].to(dtype)).double().norm())
                    for name in LEAVES}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
