"""The check that no run loaded JAX or the JAX package.  A module counts by
its top-level name, the part before the first dot, compared whole: the
port ``tpu_operator_torch`` begins with the JAX package's name
``tpu_operator`` and passes."""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "tpu_operator")


def banned_modules(names=None) -> list:
    """The loaded modules (``sys.modules`` unless ``names`` is given) whose
    top-level name is banned."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".")[0] in BANNED)
