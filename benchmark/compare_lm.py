"""The comparison that decides ``correct`` in the language-model cells:
``compare.train_gaps``' three numbers and ``token_loss_gap``, each held
to the cell's limit by ``compare.verdict`` (a number the cell gives no
limit is reported and not compared).

The router's top-k makes the norms and the mean loss poor witnesses of
precision.  A token whose k-th and (k+1)-th scores lie closer than the
rounding of the router's input takes another expert on one side (a
near-tie flip): that token's output, two experts' gradients and the
router's move by whole terms, and through the global layers' attention
the later tokens of its sequence move a little.  A flip moves the worst
leaf's norm and the mean loss as much as every product in TF32 does, and
flips are rare and uneven from seed to seed.  What TF32 moves and a flip
does not is the loss of nearly every token: ``token_loss_gap`` is the
first quartile over the tokens of the first step's forward of
|loss_program − loss_reference| / loss_reference.  A quarter of the
tokens has to move for it to move, which a few flips in a step do not
do."""

from __future__ import annotations

import torch

from benchmark import compare

# the quantile over tokens: the first quartile
TOKEN_QUANTILE = 0.25


def token_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The first quartile over tokens of |program − reference| / |reference|
    of two tensors of per-token losses of one shape."""
    if program.shape != reference.shape:
        raise ValueError(f"token losses of shapes {tuple(program.shape)} and "
                         f"{tuple(reference.shape)}")
    p, r = program.double().flatten(), reference.double().flatten()
    gaps = (p - r).abs() / r.abs().clamp_min(1e-30)
    return float(torch.quantile(gaps, TOKEN_QUANTILE))


def train_gaps(program: dict, reference: dict) -> dict:
    """``compare.train_gaps`` of the two sides and ``token_loss_gap`` of
    their ``token_losses`` (the first step's forward, per token)."""
    out = compare.train_gaps(program, reference)
    out["token_loss_gap"] = token_gap(program["token_losses"], reference["token_losses"])
    return out
