"""Context-propagated spans with a process-global tracer (a copy of
``repro.obs.trace`` but for :func:`fence`, which waits on CUDA streams).

Model (normative; docs/observability.md walks the full tree):

* a **span** is one named, timed operation: ``trace_id`` groups every
  span of one logical request, ``span_id`` names this operation, and
  ``parent_id`` links it under the operation that caused it.  Wall
  time (``ts_us``, epoch microseconds) anchors spans so trees from
  *different processes* on one machine interleave correctly; duration
  (``dur_us``) is measured with the monotonic performance counter.
* the **ambient context** is a :data:`contextvars.ContextVar` holding
  the current :class:`SpanContext` — ``span()`` parents to it and
  installs itself for the duration of the ``with`` block, which is how
  a service batch's engine call ends up nesting the engine's device
  groups and the executor's stage programs without any layer passing
  ids around explicitly.
* **cross-process propagation** uses two plain-dict helpers:
  :func:`inject` writes ``{"_trace": {"tid", "sid"}}`` into an LPRC
  JSON header, :func:`extract` reads it back; the worker attaches the
  context, handles the request, then :meth:`Tracer.take`\\ s its
  finished spans and returns them in the reply header so the router's
  tracer holds the whole tree.

Zero-cost when disabled: ``span()`` returns a shared no-op context
manager (no allocation, no lock), :func:`fence` does nothing, and the
flight recorder sees no events.  The only always-on cost is one
attribute read per call site.  Set ``LOPC_TRACE=1`` in the environment
to enable tracing at import time (how subprocess cluster workers are
switched on by ``serve.py --trace-out``).
"""
from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from typing import NamedTuple


class SpanContext(NamedTuple):
    """The two ids that travel: which trace, and which span to parent to."""

    trace_id: str
    span_id: str


_ctx: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "lopc_trace_ctx", default=None
)


def _new_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One finished-or-running operation in a trace."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "ts_us",
                 "dur_us", "tags", "status", "pid", "tid", "_t0_perf")

    def __init__(self, name: str, trace_id: str, parent_id: str | None,
                 tags: dict | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.ts_us = time.time_ns() // 1000
        self._t0_perf = time.perf_counter_ns()
        self.dur_us = 0
        self.tags = dict(tags) if tags else {}
        self.status = "ok"
        self.pid = os.getpid()
        self.tid = threading.get_ident()

    # -- mutation (running spans only) ------------------------------------

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    # -- serialization ----------------------------------------------------

    def as_dict(self) -> dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "ts_us": self.ts_us, "dur_us": self.dur_us,
            "status": self.status, "pid": self.pid, "tid": self.tid,
            "tags": self.tags,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        s = cls.__new__(cls)
        s.name = d["name"]
        s.trace_id = d["trace_id"]
        s.span_id = d["span_id"]
        s.parent_id = d.get("parent_id")
        s.ts_us = int(d["ts_us"])
        s.dur_us = int(d["dur_us"])
        s.status = d.get("status", "ok")
        s.pid = int(d.get("pid", 0))
        s.tid = int(d.get("tid", 0))
        s.tags = dict(d.get("tags") or {})
        s._t0_perf = 0
        return s


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracing fast path."""

    __slots__ = ()

    def set_tag(self, key, value):
        return self

    def context(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _SpanScope:
    """``with`` wrapper: installs the span's context, finishes on exit."""

    __slots__ = ("span", "_token")

    def __init__(self, s: Span):
        self.span = s
        self._token = None

    def __enter__(self) -> Span:
        self._token = _ctx.set(self.span.context())
        return self.span

    def __exit__(self, et, ev, tb) -> bool:
        _ctx.reset(self._token)
        if et is not None:
            self.span.status = et.__name__
            self.span.tags.setdefault("error", str(ev))
        _TRACER.finish(self.span)
        return False


class Tracer:
    """Process-global span sink: a bounded ring of finished spans.

    ``listeners`` (the flight recorder) are called with every finished
    span while enabled.  The ring is bounded so a long-running server
    holds *recent* spans; exporters should :meth:`drain` per run.
    """

    def __init__(self, max_spans: int = 65536):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._listeners: list = []
        self.enabled = False

    # -- lifecycle --------------------------------------------------------

    def enable(self, max_spans: int | None = None) -> "Tracer":
        with self._lock:
            if max_spans is not None and max_spans != self._spans.maxlen:
                self._spans = deque(self._spans, maxlen=max_spans)
            self.enabled = True
        return self

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._spans.clear()

    def add_listener(self, fn) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    # -- recording --------------------------------------------------------

    def start(self, name: str, parent: SpanContext | None = None,
              tags: dict | None = None) -> Span:
        """Start a span (manual finish).  ``parent=None`` uses the
        ambient context; a truly parentless root gets a new trace."""
        if parent is None:
            parent = _ctx.get()
        if parent is None:
            return Span(name, _new_id(), None, tags)
        return Span(name, parent.trace_id, parent.span_id, tags)

    def finish(self, s: Span, status: str | None = None) -> None:
        if s._t0_perf:
            s.dur_us = (time.perf_counter_ns() - s._t0_perf) // 1000
        if status is not None:
            s.status = status
        with self._lock:
            if not self.enabled:
                return
            self._spans.append(s)
            listeners = list(self._listeners)
        for fn in listeners:
            fn(s)

    def ingest(self, span_dicts) -> None:
        """Merge spans serialized by another process (or taken from this
        one) back into the ring — the reply-header reassembly path."""
        spans = [Span.from_dict(d) for d in span_dicts]
        with self._lock:
            if not self.enabled:
                return
            self._spans.extend(spans)
            listeners = list(self._listeners)
        for fn in listeners:
            for s in spans:
                fn(s)

    # -- reading ----------------------------------------------------------

    def take(self, trace_id: str) -> list[Span]:
        """Remove and return the finished spans of one trace (what a
        worker piggybacks onto its reply)."""
        with self._lock:
            out = [s for s in self._spans if s.trace_id == trace_id]
            if out:
                kept = [s for s in self._spans if s.trace_id != trace_id]
                self._spans.clear()
                self._spans.extend(kept)
        return out

    def snapshot(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            return [s for s in self._spans
                    if trace_id is None or s.trace_id == trace_id]

    def drain(self) -> list[Span]:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out


_TRACER = Tracer()
if os.environ.get("LOPC_TRACE", "") not in ("", "0"):
    _TRACER.enable()


def tracer() -> Tracer:
    return _TRACER


def enable(max_spans: int | None = None) -> Tracer:
    return _TRACER.enable(max_spans)


def disable() -> None:
    _TRACER.disable()


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, parent: SpanContext | None = None, **tags):
    """Open a child span of the ambient (or explicit ``parent``)
    context: ``with obs.span("exec.upload", nbytes=n) as sp: ...``.

    Returns a shared no-op context manager when tracing is disabled —
    the call site pays one attribute read and nothing else."""
    if not _TRACER.enabled:
        return NOOP_SPAN
    return _SpanScope(_TRACER.start(name, parent, tags))


def start_span(name: str, parent: SpanContext | None = None, **tags):
    """Start a detached span (finish with :func:`finish_span`) — for
    spans whose begin and end live on different threads, like a service
    request span opened at submit and closed at resolve."""
    if not _TRACER.enabled:
        return NOOP_SPAN
    return _TRACER.start(name, parent, tags)


def finish_span(s, error: BaseException | None = None) -> None:
    if s is NOOP_SPAN or isinstance(s, _NoopSpan):
        return
    if error is not None:
        s.status = type(error).__name__
        s.tags.setdefault("error", str(error))
    _TRACER.finish(s)


def current() -> SpanContext | None:
    return _ctx.get()


def context_of(s) -> SpanContext | None:
    """SpanContext of a started span (None for the no-op span)."""
    if s is NOOP_SPAN or isinstance(s, _NoopSpan):
        return None
    return s.context()


def attach(ctx: SpanContext | None):
    """Install ``ctx`` as the ambient context -> reset token."""
    return _ctx.set(ctx)


def detach(token) -> None:
    _ctx.reset(token)


# ------------------------------------------------------- wire propagation

TRACE_HEADER_KEY = "_trace"
SPANS_HEADER_KEY = "_spans"


def inject(header: dict) -> dict:
    """Copy ``header`` with the ambient trace context added (the LPRC
    router side).  Returns ``header`` unchanged when tracing is off or
    no context is active."""
    ctx = _ctx.get() if _TRACER.enabled else None
    if ctx is None:
        return header
    out = dict(header)
    out[TRACE_HEADER_KEY] = {"tid": ctx.trace_id, "sid": ctx.span_id}
    return out


def extract(header: dict) -> SpanContext | None:
    """Read a trace context out of a wire header (the worker side)."""
    t = header.get(TRACE_HEADER_KEY)
    if not isinstance(t, dict):
        return None
    tid, sid = t.get("tid"), t.get("sid")
    if not (isinstance(tid, str) and isinstance(sid, str)):
        return None
    return SpanContext(tid, sid)


# ------------------------------------------------------------ device fence

def fence(*values) -> None:
    """Wait for the device work behind ``values`` -- but only while
    tracing, so stage spans measure real device time without imposing
    sync points on untraced runs.

    ``values`` are tensors or (nested) lists and tuples of them; ``None``
    entries and CPU tensors are skipped.  For each distinct CUDA device
    among them, the device's current stream is synchronized once (the
    port launches every kernel and copy on the current stream).  While
    tracing is disabled this returns before looking at ``values``: no
    sync, no allocation."""
    if not _TRACER.enabled:
        return
    import torch

    devices = set()
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, torch.Tensor) and v.is_cuda:
            devices.add(v.device)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
