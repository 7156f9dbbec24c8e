"""The comparison that decides ``correct``: each number compared, and the
cell's limit beside it (``cells/<cell>.json``)."""

from __future__ import annotations

import statistics

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding and moves under the optimizer by round-off alone:
# its change is not compared
QUIET_LEAF = 1e-3


def leaf_gap(program: dict, reference: dict, leaves) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    median = statistics.median(reference[n] for n in reference)
    return max(abs(program[n] - reference[n]) / max(abs(reference[n]), median, 1e-30)
               for n in leaves)


def train_gaps(program: dict, reference: dict) -> dict:
    """The three numbers of a training cell.  ``program`` holds the losses
    and, per leaf, a list of norms (one a rank's view); ``reference`` the
    reference's losses and norms.

    - ``loss_gap``: the worst step's |loss − reference| / |reference|;
    - ``grad_gap``: the first gradient's norms, worst leaf and rank;
    - ``change_gap``: the change after the checked steps, worst leaf and
      rank, leaves with a quiet reference gradient left out."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"]))
    ranks = len(next(iter(program["grad_norms"].values())))
    ref_grad = reference["grad_norms"]
    median = statistics.median(ref_grad.values())
    moving = [n for n in ref_grad if ref_grad[n] >= QUIET_LEAF * median]
    grad_gap = max(leaf_gap({n: v[r] for n, v in program["grad_norms"].items()}, ref_grad,
                            ref_grad) for r in range(ranks))
    change_gap = max(leaf_gap({n: v[r] for n, v in program["change_norms"].items()},
                              reference["change_norms"], moving) for r in range(ranks))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, compared): every number at or under its limit; ``compared``
    maps each name to its value and limit, in the limits' order."""
    compared = {name: {"value": numbers.get(name), "limit": limit}
                for name, limit in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in compared.values())
    return correct, compared
