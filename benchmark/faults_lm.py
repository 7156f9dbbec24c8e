"""Faults planted in the language model's program, by name
(``module:function`` as a run's ``patch``), for the tests that must see
``correct`` come out false and for the calibration of the limits.  A
benchmark run never plants one.  Each changes what the program reads of
its configuration (``lm.LMConfig.from_dict``), so the reference, which
reads the configuration itself, is untouched:

- ``window_ignored``: the sliding layers attend causally over every key;
- ``rope_on_global``: rotary positions on the global layers too;
- ``top7``: seven experts a token for eight;
- ``shared_left_out``: no shared expert;
- ``unnormalised``: the chosen weights not divided by their sum;
- ``state_unchanged``: the step returns the parameters it was given.

``planted(name)`` plants one for the span of a ``with`` block."""

from __future__ import annotations

import contextlib
import dataclasses


def _lm():
    from tpu_operator_torch.workloads import lm

    return lm


def _config(change) -> None:
    lm = _lm()
    build = lm.LMConfig.from_dict
    lm.LMConfig.from_dict = classmethod(lambda cls, c: change(build(c)))


def window_ignored() -> None:
    _config(lambda m: dataclasses.replace(
        m, layers=tuple(dataclasses.replace(x, window=0) for x in m.layers)))


def rope_on_global() -> None:
    _config(lambda m: dataclasses.replace(
        m, layers=tuple(dataclasses.replace(x, rope=True) for x in m.layers)))


def top7() -> None:
    _config(lambda m: dataclasses.replace(m, top_k=m.top_k - 1))


def shared_left_out() -> None:
    _config(lambda m: dataclasses.replace(m, shared_width=0))


def unnormalised() -> None:
    _config(lambda m: dataclasses.replace(m, normalize=False))


def state_unchanged() -> None:
    lm = _lm()
    step = lm.train_step

    def unchanged(mesh, cfg, params, ids, lr, use_kernel=None):
        loss, _ = step(mesh, cfg, params, ids, lr, use_kernel)
        return loss, params

    lm.train_step = unchanged


FAULTS = ("window_ignored", "rope_on_global", "top7", "shared_left_out", "unnormalised")


@contextlib.contextmanager
def planted(name: str):
    lm = _lm()
    saved = lm.LMConfig.__dict__["from_dict"], lm.train_step
    globals()[name]()
    try:
        yield
    finally:
        lm.LMConfig.from_dict, lm.train_step = saved
