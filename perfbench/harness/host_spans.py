"""Per-request arithmetic over the program's finer spans, for the readers
in ``metrics/``: the engine's host steps (``engine.plan``, ``engine.tile``,
``engine.serialize``, ``engine.parse``, ``engine.assemble``), the
executor's host stages (``exec.pad``, ``exec.restore``, ``exec.concat``),
the device time of a stage (its ``device_us`` tag) and the part of a
request that no span names.

Every function takes the requests of one kind as ``spans.requests``
gives them.  A program that opens none of the named spans, or tags no
``device_us``, reads ``None``.
"""
from __future__ import annotations

from . import spans
from .profile import union

# the engine's group spans: they hold the host steps and the stages, so
# they name no work of their own
GROUPS = ("engine.compress_group", "engine.decode_group")


def named_ms(run_spans, op: str, names) -> float | None:
    """Mean milliseconds per request in the spans called ``names``, at
    any depth (``exec.restore`` sits inside ``exec.download``); None when
    no request of kind ``op`` holds one."""
    reqs = spans.requests(run_spans, op)
    hits = [s for _, m in reqs for s in m if s["name"] in names]
    if not hits:
        return None
    return sum(s["dur_us"] for s in hits) / len(reqs) / 1e3


def device_ms(run_spans, op: str, name: str) -> float | None:
    """Mean milliseconds per request of stream time in the stages called
    ``name`` (their ``device_us`` tags); None when no request of kind
    ``op`` holds one or one of them has no ``device_us``."""
    reqs = spans.requests(run_spans, op)
    hits = [s for _, m in reqs for s in m if s["name"] == name]
    if not hits or any("device_us" not in s["tags"] for s in hits):
        return None
    return sum(s["tags"]["device_us"] for s in hits) / len(reqs) / 1e3


def unattributed_ms(run_spans, op: str) -> float | None:
    """Mean milliseconds per request that no span of its trace covers
    but the request's own and the engine's groups: the request's wall
    time minus the union of every other span's interval, clipped to the
    request.  None when no request of kind ``op`` was traced."""
    reqs = spans.requests(run_spans, op)
    if not reqs:
        return None
    total = 0.0
    for root, members in reqs:
        lo, hi = root["ts_us"], root["ts_us"] + root["dur_us"]
        covered = union([(s["ts_us"], s["ts_us"] + s["dur_us"]) for s in members
                         if s["name"] not in GROUPS], lo, hi)
        total += root["dur_us"] - sum(e - s for s, e in covered)
    return total / len(reqs) / 1e3
