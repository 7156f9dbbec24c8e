"""Span API with contextvar propagation: own copy of the part of
``tpu_operator/obs/trace.py`` the workload entry points use.

Cross-process causality rides the same ``TPU_TRACEPARENT`` contract
(``<trace_id>-<span_id>[-<reconcile_id>]``, hex ids): a workload pod
``Tracer.adopt()``\\ s the operator's rollout context, so its check spans —
and through them the flight samples — join the originating trace.  In a
workload process the spans exist to stamp those ids; the operator-side
parts of the reference (the completed-trace ring, duration histograms,
fleet exemplars) stay there.
"""

from __future__ import annotations

import contextlib
import os
import time
import uuid
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Iterator, Optional

KIND_PHASE = "phase"  # workload_phase_duration_seconds{phase}

TRACEPARENT_ENV = "TPU_TRACEPARENT"

_current_tracer: ContextVar[Optional["Tracer"]] = ContextVar(
    "tpu_operator_torch_tracer", default=None
)
_current_span: ContextVar[Optional["Span"]] = ContextVar(
    "tpu_operator_torch_span", default=None
)

_HEX = set("0123456789abcdef")


def _new_id() -> str:
    return uuid.uuid4().hex[:12]


@dataclass(frozen=True)
class TraceContext:
    """The serializable cross-process slice of a span."""

    trace_id: str
    span_id: str = ""
    reconcile_id: str = ""

    @staticmethod
    def parse(value: str) -> Optional["TraceContext"]:
        """None on anything malformed — a corrupt env var must degrade to
        an untraced process, never crash a workload."""
        if not isinstance(value, str) or not value:
            return None
        parts = value.strip().split("-")
        if len(parts) not in (2, 3):
            return None
        trace_id = parts[0]
        if not trace_id or len(trace_id) > 32 or set(trace_id) - _HEX:
            return None
        span_id = parts[1] if parts[1] != "0" else ""
        reconcile_id = parts[2] if len(parts) == 3 else ""
        for part in (span_id, reconcile_id):
            if part and (len(part) > 32 or set(part) - _HEX):
                return None
        return TraceContext(trace_id, span_id, reconcile_id)

    @staticmethod
    def from_env() -> Optional["TraceContext"]:
        return TraceContext.parse(os.environ.get(TRACEPARENT_ENV, ""))


@dataclass
class Span:
    name: str
    kind: str = ""
    attrs: dict = field(default_factory=dict)
    reconcile_id: str = ""
    trace_id: str = ""
    span_id: str = field(default_factory=_new_id)
    # remote parent span id (root spans opened under an adopted context)
    remote_parent: str = ""
    parent: Optional["Span"] = field(default=None, repr=False)
    duration_s: Optional[float] = None


def current_span() -> Optional[Span]:
    return _current_span.get()


class Tracer:
    """Span factory; root spans opened under ``adopt(ctx)`` join ``ctx``'s
    trace."""

    def __init__(self):
        self._adopted: ContextVar[Optional[TraceContext]] = ContextVar(
            "tpu_operator_torch_adopted", default=None
        )

    @contextlib.contextmanager
    def adopt(self, ctx: Optional[TraceContext]) -> Iterator["Tracer"]:
        """Make this tracer ambient AND join the remote trace context;
        ``None`` degrades to plain activation."""
        adopted = self._adopted.set(ctx) if ctx is not None else None
        token = _current_tracer.set(self)
        try:
            yield self
        finally:
            _current_tracer.reset(token)
            if adopted is not None:
                self._adopted.reset(adopted)

    @contextlib.contextmanager
    def span(self, name: str, kind: str = "", **attrs) -> Iterator[Span]:
        parent = _current_span.get()
        adopted = self._adopted.get() if parent is None else None
        rid = parent.reconcile_id if parent is not None else ""
        if not rid and adopted is not None:
            rid = adopted.reconcile_id
        if parent is not None:
            tid = parent.trace_id
        elif adopted is not None:
            tid = adopted.trace_id
        else:
            tid = _new_id()
        sp = Span(
            name=name,
            kind=kind,
            attrs=attrs,
            reconcile_id=rid,
            trace_id=tid,
            remote_parent=adopted.span_id if adopted is not None else "",
            parent=parent,
        )
        t0 = time.monotonic()
        token = _current_span.set(sp)
        try:
            yield sp
        finally:
            sp.duration_s = round(time.monotonic() - t0, 6)
            _current_span.reset(token)


@contextlib.contextmanager
def span(name: str, kind: str = "", **attrs) -> Iterator[Optional[Span]]:
    """Span on the AMBIENT tracer; yields None when no tracer is active —
    workload code instruments unconditionally."""
    tracer = _current_tracer.get()
    if tracer is None:
        yield None
        return
    with tracer.span(name, kind=kind, **attrs) as sp:
        yield sp


def trace_id() -> str:
    sp = _current_span.get()
    return sp.trace_id if sp is not None else ""


def current_traceparent() -> str:
    """The active span's serialized context, ready for a ``TPU_TRACEPARENT``
    env var; empty when untraced."""
    sp = _current_span.get()
    if sp is None:
        return ""
    parts = [sp.trace_id, sp.span_id or "0"]
    if sp.reconcile_id:
        parts.append(sp.reconcile_id)
    return "-".join(parts)
