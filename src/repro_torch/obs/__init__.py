"""Observability: end-to-end tracing, unified metrics, flight recorder
(a copy of ``repro.obs``; only :func:`~repro_torch.obs.trace.fence`
differs: it waits on CUDA streams).

Three cooperating pieces, all stdlib-only and all zero-cost when
tracing is off:

* :mod:`~repro_torch.obs.trace` — context-propagated spans.  A request gets a
  ``trace_id`` at ``CompressionService.submit_*`` (or at any root
  ``span()`` a caller opens); the coalescer, the engine's device
  groups, the executor's fenced stages and the store's batched reads
  all open child spans under the ambient context, so one request's time
  is attributable stage by stage.  ``inject``/``extract`` carry the
  context across a wire header, as the reference's cluster router and
  workers do (the cluster is not ported yet).
* :mod:`~repro_torch.obs.registry` — a :class:`MetricsRegistry` of counters,
  gauges, and histograms with locked increments and a Prometheus-style
  text exposition.  The registry backs the ``ServiceMetrics``
  snapshots, and the executor's ``TRANSFER_COUNTS``/``DECODE_COUNTS``
  module globals are :class:`CounterView` views over registry counter
  families.
* :mod:`~repro_torch.obs.recorder` — a bounded per-process flight recorder of
  recent span events, dumped (with the active trace's span tree) on
  request failure and poison isolation, so an incident leaves a
  post-mortem artifact instead of a bare counter.

See docs/observability.md for the normative span model, the wire-header
trace-context format, and the flight-recorder dump layout.
"""
from .trace import (  # noqa: F401
    Span,
    SpanContext,
    Tracer,
    attach,
    context_of,
    current,
    detach,
    disable,
    enable,
    enabled,
    extract,
    fence,
    finish_span,
    inject,
    span,
    start_span,
    tracer,
)
from .registry import (  # noqa: F401
    REGISTRY,
    CounterView,
    MetricsRegistry,
)
from .recorder import (  # noqa: F401
    FLIGHT,
    FlightRecorder,
    flight_dump,
)
from .export import (  # noqa: F401
    spans_to_chrome,
    validate_trace,
    write_trace,
)
