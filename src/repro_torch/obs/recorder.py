"""Flight recorder: a bounded ring of recent span events plus a dump
hook that turns a failure into a post-mortem artifact (a copy of
``repro.obs.recorder``).

The recorder subscribes to the process tracer as a listener, so while
tracing is enabled every finished span also lands (as a compact event
dict) in a bounded deque.  On an incident — request failure, poison
isolation, ``ShardDown`` failover — the owning layer calls
:func:`flight_dump`, which snapshots the ring *and* the active trace's
full span tree into one JSON document.  Dumps are kept in memory
(bounded) and, when a directory has been configured via
:meth:`FlightRecorder.configure`, written to
``flight_<reason>_<seq>.json`` there.

Everything is a no-op while tracing is disabled: the recorder only
ever sees spans the tracer finishes, and :func:`flight_dump` returns
``None`` immediately.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import trace as _trace


class FlightRecorder:
    """Bounded in-memory ring of span events + incident dumps."""

    def __init__(self, max_events: int = 4096, max_dumps: int = 32):
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=max_events)
        self._dumps: deque[dict] = deque(maxlen=max_dumps)
        self._dir: str | None = None
        self._seq = 0
        _trace.tracer().add_listener(self._on_span)

    # -- configuration ----------------------------------------------------

    def configure(self, directory: str | None = None,
                  max_events: int | None = None) -> "FlightRecorder":
        with self._lock:
            if directory is not None:
                os.makedirs(directory, exist_ok=True)
                self._dir = directory
            if max_events is not None and max_events != self._events.maxlen:
                self._events = deque(self._events, maxlen=max_events)
        return self

    # -- listener (called by the tracer for every finished span) ----------

    def _on_span(self, s) -> None:
        evt = {
            "name": s.name, "trace_id": s.trace_id, "span_id": s.span_id,
            "ts_us": s.ts_us, "dur_us": s.dur_us, "status": s.status,
        }
        if s.tags:
            evt["tags"] = dict(s.tags)
        with self._lock:
            self._events.append(evt)

    # -- incidents ---------------------------------------------------------

    def dump(self, reason: str, trace_id: str | None = None,
             **context) -> dict | None:
        """Snapshot the ring (and one trace's span tree) into a dump.

        Returns the dump document, or ``None`` when tracing is off.
        """
        if not _trace.enabled():
            return None
        tr = _trace.tracer()
        spans = [s.as_dict() for s in tr.snapshot(trace_id)] if trace_id else []
        with self._lock:
            self._seq += 1
            doc = {
                "reason": reason,
                "seq": self._seq,
                "ts_us": time.time_ns() // 1000,
                "pid": os.getpid(),
                "trace_id": trace_id,
                "context": context,
                "trace_spans": spans,
                "recent_events": list(self._events),
            }
            self._dumps.append(doc)
            directory = self._dir
        if directory is not None:
            path = os.path.join(
                directory, f"flight_{reason}_{doc['seq']:04d}.json")
            try:
                with open(path, "w") as f:
                    json.dump(doc, f, indent=1)
                doc["path"] = path
            except OSError:
                pass
        return doc

    # -- reading -----------------------------------------------------------

    def dumps(self, reason: str | None = None) -> list[dict]:
        with self._lock:
            return [d for d in self._dumps
                    if reason is None or d["reason"] == reason]

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dumps.clear()


FLIGHT = FlightRecorder()

# Subprocess workers (cluster shards) can't be configured by API call;
# the launcher exports LOPC_FLIGHT_DIR in their environment instead.
_env_dir = os.environ.get("LOPC_FLIGHT_DIR")
if _env_dir:
    try:
        FLIGHT.configure(directory=_env_dir)
    except OSError:  # unwritable path: record in memory only
        pass


def flight_dump(reason: str, trace_id: str | None = None,
                **context) -> dict | None:
    """Record an incident on the process flight recorder (no-op while
    tracing is disabled)."""
    return FLIGHT.dump(reason, trace_id, **context)
