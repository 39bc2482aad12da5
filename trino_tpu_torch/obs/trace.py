"""Lightweight structured span tracer.

Spans model the life of a query: the trace id IS the query id, the
root span is the query itself, and children cover planning,
optimization, fragmentation, per-stage scheduling, per-task attempts,
exchange transfers, program trace/compile, and device→host pulls.

Design constraints (tracing must cost the hot path nothing when off):

- **No-op when dark.** ``Tracer.start_span`` returns a shared
  ``_NoopSpan`` singleton when no sink is registered — zero
  allocations, no clock reads, nothing to garbage-collect. Servers
  register an :class:`InMemorySpanSink`; a bare engine run traces
  nothing.
- **No deps.** Plain dataclass + ``itertools.count`` ids; durations
  come from ``time.monotonic()`` (epoch kept only for display).
- **Threads don't inherit context.** The ambient "current span" lives
  in a ``threading.local`` stack, so spans started on the same thread
  nest automatically, but work handed to another thread (query
  dispatch, exchange pulls) or another process (worker tasks over
  HTTP) must carry an explicit ``(trace_id, parent_span_id)`` pair —
  see :func:`format_trace_header` / :func:`parse_trace_header` for the
  ``X-Trino-Trace`` wire form.

A copy of ``trino_tpu/obs/trace.py``. The server's query root spans, the
engine's (``query``/``execute``, ``plan``, ``optimize``) and the
executors' (``execute_plan``, ``ingest.decode``, ``fragment``,
``fragment_execute``, ``fused_execute``, ``program_compile``,
``device_pull``, ``batched_dispatch``) serve
``/v1/query/{id}/timeline``; the cluster's task spans are ROADMAP item
9c.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

TRACE_HEADER = "X-Trino-Trace"

_ids = itertools.count(1)
# span ids must stay unique across the whole cluster: a timeline is the
# UNION of every node's span dump for one trace, and coordinator and
# worker processes each count from 1
_PROC = uuid.uuid4().hex[:6]


def _next_id(prefix: str) -> str:
    return f"{prefix}{_PROC}-{next(_ids)}"


@dataclass
class Span:
    """One timed unit of work inside a trace."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start_epoch: float
    attrs: Dict[str, Any] = field(default_factory=dict)
    duration_ms: Optional[float] = None
    status: str = "OK"
    _start_mono: float = 0.0
    _tracer: Optional["Tracer"] = None
    _done: bool = False

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def finish(self, status: str = "OK", **attrs: Any) -> None:
        """Close the span and hand it to the sinks. Idempotent."""
        if self._done:
            return
        self._done = True
        if self.duration_ms is None:
            self.duration_ms = (time.monotonic() - self._start_mono) * 1000.0
        self.status = status
        if attrs:
            self.attrs.update(attrs)
        if self._tracer is not None:
            self._tracer._record(self)

    def context(self) -> Tuple[str, str]:
        return (self.trace_id, self.span_id)

    def to_json(self) -> Dict[str, Any]:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "startMs": round(self.start_epoch * 1000.0, 1),
            "durationMs": round(self.duration_ms, 3)
            if self.duration_ms is not None
            else None,
            "status": self.status,
            "attrs": self.attrs,
        }

    # context-manager form: ``with tracer.span("plan"): ...``
    def __enter__(self) -> "Span":
        if self._tracer is not None:
            self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._tracer is not None:
            self._tracer._pop(self)
        if exc is not None and not self._done:
            self.finish(status="ERROR", error=f"{type(exc).__name__}: {exc}")
        else:
            self.finish()
        return False


class _NoopSpan:
    """Shared do-nothing span returned when no sink is registered."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None

    def set(self, key: str, value: Any) -> None:
        pass

    def finish(self, status: str = "OK", **attrs: Any) -> None:
        pass

    def context(self) -> None:
        return None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Process-global span factory fanning finished spans out to sinks."""

    def __init__(self) -> None:
        self._sinks: List[Any] = []
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- sink management ------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self._sinks)

    def add_sink(self, sink: Any) -> None:
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink: Any) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # -- ambient current-span stack (per thread) ------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def context(self) -> Optional[Tuple[str, str]]:
        """(trace_id, span_id) of the ambient span, for cross-thread/HTTP
        handoff; None when dark or outside any span."""
        cur = self.current()
        return cur.context() if cur is not None else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:  # defensive: unbalanced exit
            st.remove(span)

    # -- span creation --------------------------------------------------
    def start_span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        """Create a live span. Parentage: explicit ``parent_id`` wins,
        else the ambient current span on this thread, else root."""
        if not self._sinks:
            return NOOP_SPAN
        if parent_id is None:
            cur = self.current()
            if cur is not None:
                parent_id = cur.span_id
                if trace_id is None:
                    trace_id = cur.trace_id
        if trace_id is None:
            trace_id = _next_id("t")
        return Span(
            trace_id=trace_id,
            span_id=_next_id("s"),
            parent_id=parent_id,
            name=name,
            start_epoch=time.time(),
            attrs=dict(attrs) if attrs else {},
            _start_mono=time.monotonic(),
            _tracer=self,
        )

    def span(
        self,
        name: str,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        """``with tracer.span("optimize"): ...`` — starts, activates as
        the ambient span, and finishes on exit (ERROR on exception)."""
        return self.start_span(name, trace_id, parent_id, attrs)

    def activate(self, span):
        """Re-enter an existing span as the ambient span on THIS thread
        (e.g. the per-query dispatch thread adopting the root span that
        the HTTP handler thread created). Does not finish it on exit."""
        return _Activation(self, span)

    def record(
        self,
        name: str,
        duration_ms: float,
        attrs: Optional[Dict[str, Any]] = None,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        status: str = "OK",
    ) -> None:
        """Emit an already-measured span retroactively (e.g. compile time
        known only after the fact). No-op when dark."""
        if not self._sinks:
            return
        if parent_id is None:
            cur = self.current()
            if cur is not None:
                parent_id = cur.span_id
                if trace_id is None:
                    trace_id = cur.trace_id
        if trace_id is None:
            trace_id = _next_id("t")
        span = Span(
            trace_id=trace_id,
            span_id=_next_id("s"),
            parent_id=parent_id,
            name=name,
            start_epoch=time.time() - duration_ms / 1000.0,
            attrs=dict(attrs) if attrs else {},
            duration_ms=duration_ms,
            _tracer=self,
        )
        span._done = True
        span.status = status
        self._record(span)

    def _record(self, span: Span) -> None:
        for sink in list(self._sinks):
            try:
                sink.record(span)
            except Exception:  # noqa: BLE001 — observability must not fail queries
                pass


class _Activation:
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: Tracer, span) -> None:
        self._tracer = tracer
        self._span = span

    def __enter__(self):
        if isinstance(self._span, Span):
            self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if isinstance(self._span, Span):
            self._tracer._pop(self._span)
        return False


class InMemorySpanSink:
    """Bounded per-trace span store backing ``/v1/query/{id}/timeline``."""

    def __init__(self, max_traces: int = 256, max_spans_per_trace: int = 4096):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._traces: "OrderedDict[str, List[Dict[str, Any]]]" = OrderedDict()
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = self._traces[span.trace_id] = []
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            if len(spans) < self.max_spans_per_trace:
                spans.append(span.to_json())

    def spans_for(self, trace_id: str) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


# -- cross-process propagation (X-Trino-Trace header) -------------------

def format_trace_header(ctx: Optional[Tuple[str, str]]) -> Optional[str]:
    """``(trace_id, span_id)`` → ``"{trace_id};{span_id}"``."""
    if not ctx or not ctx[0]:
        return None
    return f"{ctx[0]};{ctx[1]}"


def parse_trace_header(value: Optional[str]) -> Optional[Tuple[str, str]]:
    if not value or ";" not in value:
        return None
    trace_id, _, span_id = value.partition(";")
    if not trace_id or not span_id:
        return None
    return (trace_id.strip(), span_id.strip())


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER
