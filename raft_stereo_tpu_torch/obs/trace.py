"""Span tracing on the telemetry bus (the port's copy of
``raft_stereo_tpu/obs/trace.py``).

``trace_id`` groups the spans of one unit of work (an eval frame, a train
step), ``span_id``/``parent_id`` nest them, and ``start_s``/``dur_s`` sit on
the same monotonic ``t`` axis every other record uses.

* **Cheap enough to leave on.** Closed spans land in an in-memory ring and
  a flush buffer, written to events.jsonl as schema-v7 ``span`` records
  once per ``flush_every`` spans. Hot loops that already own
  ``perf_counter`` stamps use :meth:`Tracer.record`, which makes a span
  from them without a timing call of its own.
* **Zero overhead when disabled.** :data:`NULL_TRACER` answers the whole
  API with no-ops, so call sites thread ``tracer`` unconditionally; a run
  with tracing off emits the same step event stream.
* **Cross-thread propagation.** The current span is thread-local; a worker
  continues a caller's trace with ``parent=tracer.current()`` captured in
  the submitting thread.
* **Referential integrity.** ``close()`` force-flushes every open span, so
  within one events.jsonl every ``parent_id`` resolves to a flushed
  ``span_id``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

#: default ring capacity (closed spans kept for the flight recorder)
RING_SIZE = 2048
#: spans buffered before a batch flush to the telemetry bus
FLUSH_EVERY = 32


class SpanContext(NamedTuple):
    """Immutable propagation token: enough to parent a span from another
    thread (capture with :meth:`Tracer.current`, pass as ``parent=``)."""

    trace_id: str
    span_id: str


class Span:
    """One open span; ``end()`` (or the context manager) closes it."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_pc",
                 "end_pc", "attrs", "thread", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str], start_pc: float,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_pc = start_pc
        self.end_pc: Optional[float] = None
        self.attrs = attrs
        self.thread = threading.current_thread().name

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, end_pc: Optional[float] = None) -> None:
        if self.end_pc is None:
            self.end_pc = time.perf_counter() if end_pc is None else end_pc
            self._tracer._finish(self)


class Tracer:
    """Span factory + ring buffer bound to one :class:`Telemetry` instance.

    Spans are stamped with ``time.perf_counter()`` and mapped onto the
    telemetry ``t`` axis via an offset captured at construction, so span
    times, event ``t`` stamps and (after the timeline merger's shift) the
    device trace share one clock.
    """

    enabled = True

    def __init__(self, telemetry=None, *, ring: int = RING_SIZE,
                 flush_every: int = FLUSH_EVERY):
        self.telemetry = telemetry
        self._lock = threading.RLock()
        self._ring: "deque" = deque(maxlen=max(16, ring))
        self._pending: List[Dict[str, Any]] = []
        self._flush_every = max(1, flush_every)
        self._open: Dict[str, Span] = {}
        self._n = itertools.count(1)
        self._local = threading.local()
        # perf_counter stamp that maps to t=0 on the telemetry axis
        t0 = getattr(telemetry, "_t0", None)
        self._t0_pc = time.perf_counter() - (
            (time.monotonic() - t0) if t0 is not None else 0.0)
        if telemetry is not None:
            telemetry.attach_tracer(self)

    # --- clock ---------------------------------------------------------------

    def to_t(self, pc_stamp: float) -> float:
        """Map a ``time.perf_counter()`` stamp to the telemetry ``t`` axis."""
        return pc_stamp - self._t0_pc

    # --- span construction ---------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[SpanContext]:
        """The calling thread's innermost open span, as a propagation token."""
        stack = self._stack()
        return stack[-1].context if stack else None

    def _ids(self, parent: Any) -> tuple:
        """Resolve (trace_id, parent_id) from an explicit parent context,
        an open Span, or None (a new root = a new trace)."""
        if isinstance(parent, Span):
            parent = parent.context
        if isinstance(parent, SpanContext):
            return parent.trace_id, parent.span_id
        return f"t{next(self._n):06x}", None

    def start(self, name: str, parent: Any = "inherit",
              **attrs: Any) -> Span:
        """Open a span (caller owns ``end()``); prefer :meth:`span`."""
        if parent == "inherit":
            parent = self.current()
        trace_id, parent_id = self._ids(parent)
        with self._lock:
            span_id = f"s{next(self._n):06x}"
        span = Span(self, name, trace_id, span_id, parent_id,
                    time.perf_counter(), attrs)
        with self._lock:
            self._open[span_id] = span
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: Any = "inherit", **attrs: Any):
        """Context manager: open a span, push it as the thread's current
        span (children nest under it), close on exit."""
        s = self.start(name, parent=parent, **attrs)
        stack = self._stack()
        stack.append(s)
        try:
            yield s
        finally:
            if stack and stack[-1] is s:
                stack.pop()
            s.end()

    def traced(self, name: Optional[str] = None, **attrs: Any):
        """Decorator form of :meth:`span`."""
        def deco(fn):
            label = name or fn.__name__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(label, **attrs):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    def record(self, name: str, start_pc: float, end_pc: float,
               parent: Any = None, **attrs: Any) -> Optional[SpanContext]:
        """Retroactively record a span from existing ``perf_counter``
        stamps — the hot-loop API: the trainer/scheduler measure their
        phases anyway; this turns the stamps into a span without a single
        extra timing call. Returns the span's context so subsequent
        ``record`` calls can parent under it."""
        trace_id, parent_id = self._ids(parent)
        with self._lock:
            span_id = f"s{next(self._n):06x}"
        span = Span(self, name, trace_id, span_id, parent_id,
                    start_pc, attrs)
        span.end_pc = end_pc
        self._finish(span)
        return SpanContext(trace_id, span_id)

    # --- ring + flush --------------------------------------------------------

    def _payload(self, span: Span, open_: bool = False) -> Dict[str, Any]:
        end = span.end_pc if span.end_pc is not None else time.perf_counter()
        payload: Dict[str, Any] = dict(
            name=span.name, span_id=span.span_id, trace_id=span.trace_id,
            start_s=round(self.to_t(span.start_pc), 6),
            dur_s=round(max(end - span.start_pc, 0.0), 6),
            thread=span.thread)
        if span.parent_id is not None:
            payload["parent_id"] = span.parent_id
        if open_:
            payload["open"] = True
        payload.update(span.attrs)
        return payload

    def _finish(self, span: Span) -> None:
        payload = self._payload(span)
        with self._lock:
            self._open.pop(span.span_id, None)
            self._ring.append(payload)
            self._pending.append(payload)
            do_flush = len(self._pending) >= self._flush_every
        if do_flush:
            self.flush()

    def flush(self) -> None:
        """Write buffered spans to the bus, in end order (children of a
        still-open parent flush first; ``close()`` flushes the parent, so
        whole-file parent_id integrity holds)."""
        with self._lock:
            batch, self._pending = self._pending, []
        if self.telemetry is not None:
            for payload in batch:
                self.telemetry.emit("span", **payload)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Ring contents (closed spans) plus still-open spans marked
        ``open=True`` — the flight recorder's span half."""
        with self._lock:
            out = list(self._ring)
            out.extend(self._payload(s, open_=True)
                       for s in self._open.values())
        return out

    def close(self) -> None:
        """End every still-open span and flush — call BEFORE the run's
        ``run_end`` record so no span lands after it."""
        with self._lock:
            still_open = list(self._open.values())
        for span in still_open:
            span.end()
        self.flush()


class _NullTracer:
    """The disabled tracer: the whole API as no-ops, so call sites thread
    a tracer unconditionally and pay nothing when tracing is off."""

    enabled = False

    @contextlib.contextmanager
    def span(self, name, parent="inherit", **attrs):
        yield None

    def traced(self, name=None, **attrs):
        return lambda fn: fn

    def start(self, name, parent="inherit", **attrs):
        raise RuntimeError("start() on the null tracer; gate on .enabled")

    def record(self, name, start_pc, end_pc, parent=None, **attrs):
        return None

    def current(self):
        return None

    def to_t(self, pc_stamp):
        return pc_stamp

    def flush(self):
        pass

    def snapshot(self):
        return []

    def close(self):
        pass


#: the shared disabled tracer (stateless, safe to share across threads)
NULL_TRACER = _NullTracer()


def tracer_for(telemetry, enabled: bool = True):
    """The call-site helper: a real :class:`Tracer` bound to ``telemetry``
    (reusing one already attached), or :data:`NULL_TRACER` when disabled
    or there is no bus to ride."""
    if not enabled or telemetry is None:
        return NULL_TRACER
    existing = getattr(telemetry, "tracer", None)
    return existing if existing is not None else Tracer(telemetry)
