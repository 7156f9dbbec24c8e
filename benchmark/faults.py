"""Faults and a control planted in the program, by name (``module:function``
as a run's ``patch``), for the tests that must see ``correct`` come out
false and for the calibration of the limits.  A benchmark run never
plants one.

Training (``collectives.transformer_step``):
- ``state_unchanged``: the step returns the parameters it was given;
- ``half_batch``: the step sees half of its batch and takes the mean over
  the rest (``reference.layer.half_of``);
- ``exchange_left_out``: the sums between cards (``collectives._sum``:
  gradients over the mesh, the loss over every rank) are skipped.

The readiness gate (kernel B1 as ``collectives.vector_add`` calls it):
- ``gate_answer_altered``: one element of the sum one step off;
- ``gate_half_rows``: the second half of the rows left unsummed;
- ``gate_state_unchanged``: the kernel hands back its first input;
- ``gate_bf16``: the control, the plain sum computed in bfloat16 in the
  kernel's place.

The readiness gate's allreduce check:
- ``gate_allreduce_altered``: one element of its buffer one off.

And ``loads_jax_package``: a module of the JAX package loaded in the gate's
process, which the check on the loaded modules has to catch."""

from __future__ import annotations

import sys
import types

import torch

from benchmark.reference.layer import half_of


def _collectives():
    from tpu_operator_torch.workloads import collectives

    return collectives


def state_unchanged() -> None:
    c = _collectives()
    step = c.transformer_step

    def unchanged(mesh, heads, params, x, lr=0.05, use_kernel=None):
        loss, _ = step(mesh, heads, params, x, lr=lr, use_kernel=use_kernel)
        return loss, params

    c.transformer_step = unchanged


def half_batch() -> None:
    c = _collectives()
    step = c.transformer_step

    def half(mesh, heads, params, x, lr=0.05, use_kernel=None):
        return step(mesh, heads, params, half_of(x).contiguous(), lr=lr, use_kernel=use_kernel)

    c.transformer_step = half


def exchange_left_out() -> None:
    c = _collectives()
    c._sum = lambda t, group, size: t


def _patch_b1(fn) -> None:
    c = _collectives()
    kernel = c.vector_add_kernel
    c.vector_add_kernel = lambda x, y: fn(kernel, x, y)


def gate_answer_altered() -> None:
    def altered(kernel, x, y):
        out = kernel(x, y)
        out.view(-1)[0] = torch.nextafter(out.view(-1)[0], out.new_tensor(float("inf")))
        return out

    _patch_b1(altered)


def gate_half_rows() -> None:
    def half(kernel, x, y):
        out = torch.zeros_like(x)
        rows = x.shape[0] // 2
        out[:rows] = kernel(x[:rows].contiguous(), y[:rows].contiguous())
        return out

    _patch_b1(half)


def gate_state_unchanged() -> None:
    _patch_b1(lambda kernel, x, y: x.clone())


def gate_bf16() -> None:
    _patch_b1(lambda kernel, x, y: (x.bfloat16() + y.bfloat16()).float())


def gate_allreduce_altered() -> None:
    """One element of the allreduce check's buffer one off where it is made."""
    c = _collectives()
    rank_fn = c._allreduce_rank
    ones = torch.ones

    def altered(*shape, **kwargs):
        t = ones(*shape, **kwargs)
        if t.dtype == torch.bfloat16:
            t.view(-1)[0] = 2.0
        return t

    def allreduce_rank(*args, **kwargs):
        torch.ones = altered
        try:
            return rank_fn(*args, **kwargs)
        finally:
            torch.ones = ones

    c._allreduce_rank = allreduce_rank


def loads_jax_package() -> None:
    """A module of the JAX package loaded in the gate's process."""
    sys.modules["tpu_operator.x"] = types.ModuleType("tpu_operator.x")
