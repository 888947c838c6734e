"""Cluster-level metrics: per-shard health + aggregated worker metrics
(a copy of ``repro.cluster.metrics``, over the port's ``ServiceMetrics``,
whose fields and types are the reference's).

The router records what only it can see — scatter/gather traffic,
transport failures, reads served by a non-primary replica — while each
worker's own :class:`~repro_torch.service.metrics.ServiceMetrics` keeps
counting inside its process exactly as in single-process serving.
:meth:`ClusterMetrics.aggregate` folds the workers' snapshots (fetched
over ``OP_METRICS``) into cluster totals, so the probe contracts
(``traces_added``, transfer byte totals, cache hit rates) stay
checkable across worker boundaries: the cluster's ``bytes_h2d`` is the
sum of its workers', a dead worker contributes nothing, and nothing is
double-counted because every probe increments in exactly one process.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, fields as dataclass_fields

from ..service.metrics import ServiceMetrics

# Worker ServiceMetrics fields that do NOT sum meaningfully across
# shards: per-shard instantaneous state, means/ratios (recomputed or
# dropped — a mean of per-shard means would weight idle shards equally
# with hot ones), window percentiles, and the max.  Every *other*
# numeric ServiceMetrics field is summed by introspection, so adding a
# counter to ServiceMetrics automatically joins cluster aggregation;
# adding a non-summable numeric field without listing it here fails
# the guard in _summable_fields (and the tier-1 test on it).
_NON_SUMMABLE = frozenset({
    "queue_depth",
    "mean_batch_occupancy", "max_batch_occupancy",
    "mean_device_group_occupancy",
    "bucket_pad_waste", "decoded_tiles_per_request",
    "p50_ms", "p99_ms", "mean_ms", "mbps",
})


def _summable_fields() -> tuple[str, ...]:
    """int-typed ServiceMetrics fields minus the explicit exemptions."""
    out, numeric = [], set()
    for f in dataclass_fields(ServiceMetrics):
        if f.type in ("int", "float", int, float):
            numeric.add(f.name)
            if f.name not in _NON_SUMMABLE and f.type in ("int", int):
                out.append(f.name)
    unknown = _NON_SUMMABLE - numeric
    if unknown:
        raise TypeError(
            f"_NON_SUMMABLE names missing from ServiceMetrics: {unknown}")
    missing = numeric - set(out) - _NON_SUMMABLE
    if missing:
        raise TypeError(
            "numeric ServiceMetrics fields neither summed nor exempted: "
            f"{missing} — add them to _NON_SUMMABLE or make them int "
            "counters")
    return tuple(out)


_SUM_FIELDS = _summable_fields()


@dataclass
class ShardHealth:
    """Router-side view of one shard's transport health."""

    up: bool = True
    failures: int = 0            # transport failures (ShardDown) seen
    last_error: str = ""

    def as_dict(self) -> dict:
        return {"up": self.up, "failures": self.failures,
                "last_error": self.last_error}


@dataclass
class ClusterMetrics:
    """Thread-safe router counters + shard health (one per cluster)."""

    n_shards: int
    reads: int = 0               # router read operations (roi/frame/full)
    writes: int = 0              # router write operations
    tiles_read: int = 0          # tiles gathered across all reads
    failover_reads: int = 0      # tiles served by a non-primary replica
    bytes_written: int = 0       # full-container bytes accepted for write
    shards: list = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()
        if not self.shards:
            self.shards = [ShardHealth() for _ in range(self.n_shards)]

    # ------------------------------------------------------------- recording

    def record_read(self, n_tiles: int = 0) -> None:
        with self._lock:
            self.reads += 1
            self.tiles_read += int(n_tiles)

    def record_write(self, nbytes: int) -> None:
        with self._lock:
            self.writes += 1
            self.bytes_written += int(nbytes)

    def record_failover(self, n_tiles: int = 1) -> None:
        """A replica (not the primary) served ``n_tiles`` tile reads."""
        with self._lock:
            self.failover_reads += int(n_tiles)

    def record_shard_failure(self, shard: int, err: BaseException) -> None:
        with self._lock:
            h = self.shards[shard]
            h.up = False
            h.failures += 1
            h.last_error = f"{type(err).__name__}: {err}"

    def record_shard_ok(self, shard: int) -> None:
        with self._lock:
            self.shards[shard].up = True

    def is_down(self, shard: int) -> bool:
        with self._lock:
            return not self.shards[shard].up

    # ------------------------------------------------------------- reporting

    def snapshot(self) -> dict:
        """Router-side counters + per-shard health as plain JSON."""
        with self._lock:
            return {
                "n_shards": self.n_shards,
                "reads": self.reads,
                "writes": self.writes,
                "tiles_read": self.tiles_read,
                "failover_reads": self.failover_reads,
                "bytes_written": self.bytes_written,
                "shards": [h.as_dict() for h in self.shards],
            }

    @staticmethod
    def aggregate(worker_snapshots) -> dict:
        """Fold per-worker ``ServiceMetrics`` dicts into cluster totals.

        ``worker_snapshots`` holds one metrics dict per shard, or
        ``None`` for a shard that could not be polled (down).  Summable
        counters add; the cache hit rate is recomputed from the summed
        hits/misses (a mean of per-shard rates would weight idle shards
        equally with hot ones).
        """
        present = [m for m in worker_snapshots if m]
        out = {k: sum(int(m.get(k, 0)) for m in present) for k in _SUM_FIELDS}
        looked = out["cache_hits"] + out["cache_misses"]
        out["cache_hit_rate"] = out["cache_hits"] / looked if looked else 0.0
        out["workers_reporting"] = len(present)
        return out

    def lines(self, aggregated: dict | None = None) -> list[str]:
        """Human-readable summary (one string per line), mirroring
        ``ServiceMetrics.lines``; pass :meth:`aggregate`'s result to
        append the cross-worker totals."""
        snap = self.snapshot()
        down = [i for i, h in enumerate(snap["shards"]) if not h["up"]]
        out = [
            f"cluster    {snap['n_shards']} shards"
            + (f", DOWN: {down}" if down else ", all up"),
            f"router     {snap['reads']} reads ({snap['tiles_read']} tiles, "
            f"{snap['failover_reads']} served by replicas), "
            f"{snap['writes']} writes "
            f"({snap['bytes_written'] / 1e6:.1f} MB accepted)",
        ]
        if aggregated:
            out.append(
                f"workers    {aggregated['workers_reporting']} reporting; "
                f"{aggregated['completed']}/{aggregated['submitted']} "
                f"requests, cache hit rate "
                f"{aggregated['cache_hit_rate']:.2f}, "
                f"{aggregated['traces_added']} traces added, "
                f"{aggregated['bytes_h2d'] / 1e6:.1f} MB up / "
                f"{aggregated['bytes_d2h'] / 1e6:.1f} MB down"
            )
        return out
