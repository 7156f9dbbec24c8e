"""Span API with contextvar propagation: own copy of the part of
``tpu_operator/obs/trace.py`` the workload entry points use.

Cross-process causality rides the same ``TPU_TRACEPARENT`` contract
(``<trace_id>-<span_id>[-<reconcile_id>]``, hex ids): a workload pod
``Tracer.adopt()``\\ s the operator's rollout context, so its check spans —
and through them the flight samples — join the originating trace.  The
local launcher (``workloads/_ranks.py``) hands the same context to the
ranks it spawns.

A span records its start and end on ``time.monotonic()``, the clock every
process of the host shares, with its parent, trace id and attrs.  The
active tracer keeps its finished spans in memory as ``Span.to_dict()``,
up to ``Tracer.KEEP`` (later ones are counted in ``dropped``), and hands
them out with ``spans()``; a rank ships its own back to the launcher,
which ``replay()``\\ s them into the caller's tracer as they came.
While ``torch.profiler`` records, a span also opens a ``record_function``
range of its name, so the profiler's trace shows it beside the device work
it launched (the benchmark's attribution of device time to the blocks of
the train step reads those ranges).  With no tracer active, ``span()`` is one
``ContextVar`` lookup: no range, no clock read, nothing kept.  The
operator-side parts of the reference (the completed-trace ring, duration
histograms, fleet exemplars) stay there.
"""

from __future__ import annotations

import contextlib
import os
import sys
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
    start: float = 0.0  # time.monotonic()
    end: Optional[float] = None  # None while open

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    @property
    def parent_id(self) -> str:
        return self.parent.span_id if self.parent is not None else self.remote_parent

    def to_dict(self) -> dict:
        """The finished span as JSON (what a rank ships to its launcher)."""
        return {"name": self.name, "kind": self.kind, "attrs": self.attrs,
                "reconcile_id": self.reconcile_id, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start, "end": self.end}


def current_span() -> Optional[Span]:
    return _current_span.get()


def _profiler_range(name: str):
    """A ``record_function`` range of ``name`` while ``torch.profiler``
    records, else None.  torch is never imported here: a process that has
    not imported it has no profiler running."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    return torch.profiler.record_function(name)


class Tracer:
    """Span factory; root spans opened under ``adopt(ctx)`` join ``ctx``'s
    trace.  Keeps its first ``KEEP`` finished spans (a validator's long
    burn-in must not grow it without end) and counts the rest in
    ``dropped``."""

    KEEP = 10_000

    def __init__(self):
        self._adopted: ContextVar[Optional[TraceContext]] = ContextVar(
            "tpu_operator_torch_adopted", default=None
        )
        self._finished: list[dict] = []
        self.dropped = 0

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

    def _open(self, name: str, kind: str, attrs: dict) -> Span:
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
        return Span(
            name=name,
            kind=kind,
            attrs=attrs,
            reconcile_id=rid,
            trace_id=tid,
            remote_parent=adopted.span_id if adopted is not None else "",
            parent=parent,
            start=time.monotonic(),
        )

    def keep(self, sp: dict) -> None:
        """Add a finished span (``Span.to_dict()``) to the kept ones, or
        count it dropped."""
        if len(self._finished) < self.KEEP:
            self._finished.append(sp)
        else:
            self.dropped += 1

    def spans(self) -> list[dict]:
        """The kept finished spans, as ``Span.to_dict()``, in the order they
        ended."""
        return list(self._finished)

    @contextlib.contextmanager
    def span(self, name: str, kind: str = "", **attrs) -> Iterator[Span]:
        sp = self._open(name, kind, attrs)
        token = _current_span.set(sp)
        rf = _profiler_range(name)
        try:
            if rf is None:
                yield sp
            else:
                with rf:
                    yield sp
        finally:
            sp.end = time.monotonic()
            _current_span.reset(token)
            self.keep(sp.to_dict())

    def record(self, name: str, start: float, end: float, kind: str = "", **attrs) -> Span:
        """A finished span of an interval measured elsewhere (a rank's start,
        stamped by the process that spawned it), placed as ``span()`` would
        place it."""
        sp = self._open(name, kind, attrs)
        sp.start, sp.end = start, end
        self.keep(sp.to_dict())
        return sp


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


def replay(spans: list[dict], dropped: int = 0) -> None:
    """Keep spans finished in another process (``Span.to_dict()``, a rank
    of the local launcher) in the ambient tracer; nothing when untraced."""
    tracer = _current_tracer.get()
    if tracer is None:
        return
    for d in spans:
        tracer.keep(d)
    tracer.dropped += dropped


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
