"""Service metrics: counters, latency percentiles, batch occupancy (a
copy of ``repro.service.metrics``).

The recorder is the single mutation point and ``snapshot`` freezes it
into a plain :class:`ServiceMetrics` for printing/JSON — same numbers
as always, but the storage underneath is the unified observability
registry (``repro_torch.obs.REGISTRY``): every counter lives in a labeled
metric family (label ``svc`` = this recorder instance), so one
``expose_text()`` call renders every live service in Prometheus text
format next to the executor's transfer probes.  The snapshot path and
every committed CI gate keep reading the identical values.

Latency is recorded per *request* (submit -> future resolved, i.e. the
full queue wait + coalesce delay + device batch), kept in a bounded
window so a long-running server reports recent percentiles rather than
lifetime ones (a registry histogram gets the same observations for
exposition).  Occupancy is recorded per *drained batch* (requests the
coalescer flushed together) and per *device group* (requests sharing
one ``compress_many``/``decompress_many`` device batch, via the
engine's ``group_cb`` hook) — the second is the number that proves
coalescing reaches the device, not just the queue.

Degenerate windows are explicit, not garbage: ``mbps`` is 0.0 whenever
the busy-time denominator is zero/instant (no ZeroDivisionError, no
inf from a sub-microsecond window), percentiles clamp their rank into
the window, and ``lat_samples`` reports the window size so a consumer
can tell a p99 computed from one sample from a meaningful one.
"""
from __future__ import annotations

import itertools
import math
import threading
from collections import deque
from dataclasses import dataclass, field

from ..obs import REGISTRY


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sequence.

    Empty windows read 0.0; ``q`` outside [0, 100] clamps to the window
    ends instead of indexing out of range.  Note a one-element window
    necessarily reports every percentile as that sample — check the
    window size (``ServiceMetrics.lat_samples``) before trusting tail
    percentiles.
    """
    if not sorted_vals:
        return 0.0
    q = min(100.0, max(0.0, q))
    rank = min(len(sorted_vals),
               max(1, math.ceil(q / 100.0 * len(sorted_vals))))
    return float(sorted_vals[rank - 1])


def safe_rate(numerator: float, denominator: float) -> float:
    """``numerator / denominator`` guarded for idle/instant windows:
    0.0 for a non-positive denominator or a non-finite quotient."""
    if denominator <= 0.0:
        return 0.0
    out = numerator / denominator
    return out if math.isfinite(out) else 0.0


@dataclass
class ServiceMetrics:
    """One frozen reading of the service counters."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    queue_depth: int = 0
    batches: int = 0
    mean_batch_occupancy: float = 0.0
    max_batch_occupancy: int = 0
    device_groups: int = 0
    mean_device_group_occupancy: float = 0.0
    traces_added: int = 0                 # kernel libraries loaded by batches
    bucket_real_tiles: int = 0            # tiles carried by device batches
    bucket_padded_tiles: int = 0          # dead pad tiles in those batches
    bucket_pad_waste: float = 0.0         # padded / real
    bucket_batches: dict = field(default_factory=dict)  # capacity -> count
    store_reads: int = 0                  # store read requests served
    cache_hits: int = 0                   # decoded-tile cache, store reads
    cache_misses: int = 0
    cache_evictions: int = 0
    decoded_tiles_per_request: float = 0.0
    lat_samples: int = 0                  # latency window size at snapshot
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    mean_ms: float = 0.0
    mbps: float = 0.0                     # payload MB / batch-busy second
    per_kind: dict = field(default_factory=dict)
    transfers: dict = field(default_factory=dict)
    bytes_h2d: int = 0                    # total uploaded payload bytes
    bytes_d2h: int = 0                    # total downloaded payload bytes

    def lines(self) -> list[str]:
        """Human-readable summary (one string per line)."""
        return [
            f"requests   {self.completed}/{self.submitted} completed, "
            f"{self.rejected} rejected, {self.failed} failed "
            f"(queue depth {self.queue_depth})",
            f"latency    p50 {self.p50_ms:.1f} ms, p99 {self.p99_ms:.1f} ms, "
            f"mean {self.mean_ms:.1f} ms ({self.lat_samples} samples)",
            f"batches    {self.batches} drained, occupancy mean "
            f"{self.mean_batch_occupancy:.2f} / max {self.max_batch_occupancy}; "
            f"{self.device_groups} device groups, "
            f"{self.mean_device_group_occupancy:.2f} requests each",
            f"tile cache {self.cache_hits} hits / {self.cache_misses} misses "
            f"/ {self.cache_evictions} evictions over {self.store_reads} "
            f"store reads; {self.decoded_tiles_per_request:.2f} decoded "
            "tiles/request",
            f"buckets    {self.traces_added} traces added; pad waste "
            f"{self.bucket_pad_waste:.2f} ({self.bucket_padded_tiles} padded "
            f"/ {self.bucket_real_tiles} real tiles) over capacities "
            f"{self.bucket_batches}",
            f"throughput {self.mbps:.1f} MB/s busy; per kind {self.per_kind}",
            f"transfers  {self.transfers}",
            f"xfer bytes {self.bytes_h2d / 1e6:.1f} MB up, "
            f"{self.bytes_d2h / 1e6:.1f} MB down",
        ]


# latency histogram buckets: 0.5 ms .. 10 s, the serving range
_LAT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_INSTANCE_IDS = itertools.count()


class MetricsRecorder:
    """Thread-safe accumulator behind :class:`ServiceMetrics`.

    Each recorder is one labeled instance (``svc=<instance>``) in the
    shared registry's service metric families; the recorder's own lock
    still serializes multi-family updates so a snapshot never reads a
    half-applied ``record_batch``.
    """

    def __init__(self, latency_window: int = 4096, registry=None,
                 instance: str | None = None):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=latency_window)
        self.registry = registry or REGISTRY
        self.instance = instance or f"svc{next(_INSTANCE_IDS)}"
        r = self.registry
        # one family per logical counter group; series are (svc, ...) rows
        self._events = r.counter(
            "lopc_service_events_total",
            "request lifecycle events (submitted/completed/...)")
        self._kinds = r.counter(
            "lopc_service_submitted_by_kind_total",
            "submitted requests by kind")
        self._batch = r.counter(
            "lopc_service_batch_total",
            "coalescer batch aggregates (batches/occupancy/busy/payload)")
        self._occ_max = r.gauge(
            "lopc_service_batch_occupancy_max",
            "largest coalesced batch seen")
        self._groups = r.counter(
            "lopc_service_device_group_total",
            "engine device groups and their member requests")
        self._buckets = r.counter(
            "lopc_service_bucket_batches_total",
            "device batches by capacity class")
        self._store = r.counter(
            "lopc_service_store_total",
            "batched store reads: requests/tiles/cache events")
        self._xfer = r.counter(
            "lopc_service_transfers_total",
            "executor transfer deltas attributed to this service")
        self._latency = r.histogram(
            "lopc_service_latency_seconds",
            "request latency, submit to future resolution",
            buckets=_LAT_BUCKETS)

    # -- family helpers (hold self._lock when calling) ---------------------

    def _ev(self, event: str, n: float = 1) -> None:
        self._events.inc(n, svc=self.instance, event=event)

    def _ev_val(self, event: str) -> float:
        return self._events.value(svc=self.instance, event=event)

    def _batch_val(self, fld: str) -> float:
        return self._batch.value(svc=self.instance, field=fld)

    def _groups_val(self, fld: str) -> float:
        return self._groups.value(svc=self.instance, field=fld)

    def _store_val(self, fld: str) -> float:
        return self._store.value(svc=self.instance, field=fld)

    # -- recording ---------------------------------------------------------

    def record_submit(self, kind: str) -> None:
        with self._lock:
            self._ev("submitted")
            self._kinds.inc(1, svc=self.instance, kind=kind)

    def record_reject(self) -> None:
        with self._lock:
            self._ev("rejected")

    def record_done(self, latency_s: float, ok: bool) -> None:
        with self._lock:
            if ok:
                self._ev("completed")
                self._lat.append(latency_s)
                self._latency.observe(latency_s, svc=self.instance)
            else:
                self._ev("failed")

    def record_batch(self, n_requests: int, seconds: float,
                     payload_bytes: int, transfers: dict,
                     traces_added: int = 0) -> None:
        with self._lock:
            self._batch.inc(1, svc=self.instance, field="batches")
            self._batch.inc(n_requests, svc=self.instance,
                            field="occupancy_sum")
            self._batch.inc(seconds, svc=self.instance, field="busy_seconds")
            self._batch.inc(payload_bytes, svc=self.instance,
                            field="payload_bytes")
            self._batch.inc(traces_added, svc=self.instance,
                            field="traces_added")
            if n_requests > self._occ_max.value(svc=self.instance):
                self._occ_max.set(n_requests, svc=self.instance)
            for k, v in transfers.items():
                self._xfer.inc(v, svc=self.instance, key=k)

    def record_device_group(self, info: dict) -> None:
        with self._lock:
            self._groups.inc(1, svc=self.instance, field="groups")
            self._groups.inc(int(info["n_requests"]), svc=self.instance,
                             field="requests")
            # bucket admission: the (real, capacity) device batches this
            # group ran as (engine group_cb "tile_batches")
            for n_real, capacity in info.get("tile_batches", ()):
                self._groups.inc(int(n_real), svc=self.instance,
                                 field="bucket_real_tiles")
                self._groups.inc(int(capacity) - int(n_real),
                                 svc=self.instance,
                                 field="bucket_padded_tiles")
                self._buckets.inc(1, svc=self.instance,
                                  capacity=str(int(capacity)))

    def record_store_read(self, info: dict) -> None:
        """One batched store read (``LopcStore.read_roi_many``'s
        ``stats_cb`` summary): requests served, tiles requested vs
        actually decoded, and the decoded-tile cache's hit/miss/eviction
        deltas — the counters that prove hot reads skip the decode."""
        with self._lock:
            for fld in ("n_requests", "tiles_requested", "tiles_decoded",
                        "cache_hits", "cache_misses", "cache_evictions"):
                self._store.inc(int(info[fld]), svc=self.instance, field=fld)

    def reset_window(self) -> None:
        """Clear the latency window (load tests call this between load
        points so percentiles describe one point, not the lifetime)."""
        with self._lock:
            self._lat.clear()

    def mean_batch_seconds(self) -> float:
        with self._lock:
            return safe_rate(self._batch_val("busy_seconds"),
                             self._batch_val("batches"))

    # -- reading -----------------------------------------------------------

    def transfers_dict(self) -> dict:
        """This instance's transfer-delta counters, keyed bare."""
        out = {}
        for labels, v in self._xfer.series().items():
            row = dict(labels)
            if row.get("svc") == self.instance:
                iv = int(v)
                out[row["key"]] = iv if iv == v else v
        return out

    def snapshot(self, queue_depth: int = 0) -> ServiceMetrics:
        with self._lock:
            lat = sorted(self._lat)
            batches = int(self._batch_val("batches"))
            groups = int(self._groups_val("groups"))
            real = int(self._groups_val("bucket_real_tiles"))
            padded = int(self._groups_val("bucket_padded_tiles"))
            store_reads = int(self._store_val("n_requests"))
            bucket_batches = {}
            for labels, v in self._buckets.series().items():
                row = dict(labels)
                if row.get("svc") == self.instance:
                    bucket_batches[int(row["capacity"])] = int(v)
            per_kind = {}
            for labels, v in self._kinds.series().items():
                row = dict(labels)
                if row.get("svc") == self.instance:
                    per_kind[row["kind"]] = int(v)
            transfers = self.transfers_dict()
            return ServiceMetrics(
                submitted=int(self._ev_val("submitted")),
                completed=int(self._ev_val("completed")),
                failed=int(self._ev_val("failed")),
                rejected=int(self._ev_val("rejected")),
                queue_depth=queue_depth,
                batches=batches,
                mean_batch_occupancy=safe_rate(
                    self._batch_val("occupancy_sum"), batches),
                max_batch_occupancy=int(
                    self._occ_max.value(svc=self.instance)),
                device_groups=groups,
                mean_device_group_occupancy=safe_rate(
                    self._groups_val("requests"), groups),
                traces_added=int(self._batch_val("traces_added")),
                bucket_real_tiles=real,
                bucket_padded_tiles=padded,
                bucket_pad_waste=safe_rate(padded, real),
                bucket_batches=bucket_batches,
                store_reads=store_reads,
                cache_hits=int(self._store_val("cache_hits")),
                cache_misses=int(self._store_val("cache_misses")),
                cache_evictions=int(self._store_val("cache_evictions")),
                decoded_tiles_per_request=safe_rate(
                    self._store_val("tiles_decoded"), store_reads),
                lat_samples=len(lat),
                p50_ms=percentile(lat, 50) * 1e3,
                p99_ms=percentile(lat, 99) * 1e3,
                mean_ms=(sum(lat) / len(lat) * 1e3 if lat else 0.0),
                mbps=safe_rate(self._batch_val("payload_bytes") / 1e6,
                               self._batch_val("busy_seconds")),
                per_kind=per_kind,
                # byte totals ride the same counter stream as the
                # crossing counts but print as their own row
                transfers={k: v for k, v in transfers.items()
                           if not k.startswith("bytes_")},
                bytes_h2d=int(transfers.get("bytes_h2d", 0)),
                bytes_d2h=int(transfers.get("bytes_d2h", 0)),
            )
