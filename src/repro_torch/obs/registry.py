"""Unified metrics registry: counters, gauges, histograms (a copy of
``repro.obs.registry``).

One :class:`MetricsRegistry` per process (:data:`REGISTRY`).  Metric
*families* are created lazily by name; each family holds labeled
series (a tuple of label values -> one series) behind a per-family
lock, so increments from concurrent services never lose updates.  The
existing ``ServiceMetrics``/``ClusterMetrics`` snapshots read the same
numbers they always did — the registry is the storage underneath, not
a replacement API — and :meth:`MetricsRegistry.expose_text` renders
everything in the Prometheus text exposition format for
``serve.py --metrics-dump``.

:class:`CounterView` keeps the executor's historical module globals
(``TRANSFER_COUNTS``/``DECODE_COUNTS``) working: it is a
``collections.Counter``-shaped view over one counter family whose
``add()`` is atomic.  Existing readers (``dict(TRANSFER_COUNTS)``,
``TRANSFER_COUNTS["h2d_tiles"]``, ``.clear()``) behave exactly as
before, including the Counter convention that a missing key reads 0.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from collections.abc import MutableMapping

_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class CounterFamily:
    """A named family of monotonically increasing labeled counters."""

    kind = "counter"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._series.get(key, 0)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)


class GaugeFamily:
    """A named family of labeled gauges (set to the latest value)."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = value

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._series.get(key, 0)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)


class HistogramFamily:
    """Fixed-bucket cumulative histograms (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 buckets: tuple = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        # key -> [per-bucket counts..., +Inf count, sum]
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                row = [0] * (len(self.buckets) + 1) + [0.0]
                self._series[key] = row
            # bisect_right lands on len(buckets) for value > max -> +Inf slot
            row[bisect_right(self.buckets, value)] += 1
            row[-1] += value

    def counts(self, **labels) -> dict:
        key = _label_key(labels)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                return {"count": 0, "sum": 0.0, "buckets": [0] * (len(self.buckets) + 1)}
            return {"count": sum(row[:-1]), "sum": row[-1],
                    "buckets": list(row[:-1])}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def series(self) -> dict[tuple, list]:
        with self._lock:
            return {k: list(v) for k, v in self._series.items()}


class MetricsRegistry:
    """Get-or-create registry of metric families by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, object] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, **kwargs)
                self._families[name] = fam
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            return fam

    def counter(self, name: str, help_text: str = "") -> CounterFamily:
        return self._get(name, CounterFamily, help_text=help_text)

    def gauge(self, name: str, help_text: str = "") -> GaugeFamily:
        return self._get(name, GaugeFamily, help_text=help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: tuple = _DEFAULT_BUCKETS) -> HistogramFamily:
        return self._get(name, HistogramFamily, help_text=help_text,
                         buckets=buckets)

    def families(self) -> list:
        with self._lock:
            return list(self._families.values())

    def expose_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family."""
        out = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            if fam.kind == "histogram":
                for key, row in sorted(fam.series().items()):
                    cum = 0
                    for le, n in zip(fam.buckets, row[:-2]):
                        cum += n
                        lk = key + (("le", repr(le)),)
                        out.append(f"{fam.name}_bucket{_fmt_labels(lk)} {cum}")
                    cum += row[-2]
                    lk = key + (("le", "+Inf"),)
                    out.append(f"{fam.name}_bucket{_fmt_labels(lk)} {cum}")
                    out.append(f"{fam.name}_sum{_fmt_labels(key)} {row[-1]}")
                    out.append(f"{fam.name}_count{_fmt_labels(key)} {cum}")
            else:
                for key, v in sorted(fam.series().items()):
                    out.append(f"{fam.name}{_fmt_labels(key)} {v}")
        return "\n".join(out) + "\n"


REGISTRY = MetricsRegistry()


class CounterView(MutableMapping):
    """Counter-compatible view of one counter family's key label.

    The executor's probe globals were plain ``collections.Counter``
    objects mutated with ``c[k] += n`` — a read-modify-write that loses
    updates under concurrent services.  Internal call sites now use the
    atomic :meth:`add`; external readers keep every Counter idiom they
    relied on: zero-default ``[]``, ``dict()``, ``.clear()``, ``in``,
    iteration, and ``len``.
    """

    def __init__(self, family: CounterFamily, label: str = "key"):
        self._family = family
        self._label = label

    # -- the safe write path ----------------------------------------------

    def add(self, key: str, n: int = 1) -> None:
        self._family.inc(n, **{self._label: key})

    # -- Counter-compatible surface ---------------------------------------

    def __getitem__(self, key: str) -> int:
        v = self._family.value(**{self._label: key})
        iv = int(v)
        return iv if iv == v else v

    def __setitem__(self, key: str, value) -> None:
        # Supports legacy `c[k] += n` (read then set). Tolerated for
        # external callers; internal sites use add().
        cur = self[key]
        self._family.inc(value - cur, **{self._label: key})

    def __delitem__(self, key: str) -> None:
        self.__setitem__(key, 0)

    def __iter__(self):
        for key, v in self._family.series().items():
            if v:
                yield dict(key)[self._label]

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __contains__(self, key) -> bool:
        return self._family.value(**{self._label: key}) != 0

    def clear(self) -> None:
        self._family.clear()

    def __repr__(self) -> str:
        return f"CounterView({dict(self)!r})"
