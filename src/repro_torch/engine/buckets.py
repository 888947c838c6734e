"""Shape-bucketed admission: a closed set of resident-batch geometries.

A numpy copy of ``repro.engine.buckets``.

Why a *closed* set: every distinct resident-batch capacity is a distinct
batch geometry, and under serving load the request mix makes group tile
counts effectively random.  Capacity *classes* ``floor * 2**k`` and a
packing cap keep the geometries a deployment can ever touch enumerable:
batches larger than the cap split into chunks.

Byte contract: classes only change how many masked dead tiles pad a
device batch, and chunk boundaries never cross a request (compress) or a
tile (decode), so bucketing never changes a request's container bytes.

``BUCKET_COUNTS`` records every device batch by ``(kind, capacity)`` and
``PAD_COUNTS`` the real/padded tile split (fed by the executor), so
benches and the service metrics can report bucket occupancy and pad
waste per load point.
"""
from __future__ import annotations

import threading
from collections import Counter

CAPACITY_FLOOR = 8

# Packing cap: chunks never exceed floor * 2**MAX_DOUBLINGS tiles, so
# the class set {floor * 2**k, k <= MAX_DOUBLINGS} is closed for any
# traffic whose single requests fit (an oversized single request gets a
# chunk of its own at the smallest class that holds it).
MAX_DOUBLINGS = 4

BUCKET_COUNTS: Counter = Counter()  # (kind, capacity) -> batches
PAD_COUNTS: Counter = Counter()     # "real" / "padded" tile tallies
_LOCK = threading.Lock()            # the service records from its threads


def bucket_capacity(n_tiles: int, floor: int = CAPACITY_FLOOR) -> int:
    """Smallest capacity class ``floor * 2**k`` holding ``n_tiles``."""
    floor = max(4, floor)
    cap = floor
    while cap < n_tiles:
        cap *= 2
    return cap


def capacity_classes(floor: int = CAPACITY_FLOOR) -> tuple[int, ...]:
    """The closed class set reachable by packed (non-oversize) batches."""
    floor = max(4, floor)
    return tuple(floor * 2**k for k in range(MAX_DOUBLINGS + 1))


def packing_cap(floor: int = CAPACITY_FLOOR) -> int:
    return max(4, floor) * 2**MAX_DOUBLINGS


def plan_request_chunks(sizes, floor: int = CAPACITY_FLOOR):
    """Split a compress group into chunks at request boundaries.

    ``sizes`` are per-request tile counts in member order.  Greedy
    packing up to the cap; a single request larger than the cap rides a
    chunk of its own (its class is then size-determined, hence still
    stable for that request shape).  -> list of (lo, hi) member spans.
    """
    cap = packing_cap(floor)
    spans: list[tuple[int, int]] = []
    lo, acc = 0, 0
    for i, n in enumerate(sizes):
        if acc and acc + n > cap:
            spans.append((lo, i))
            lo, acc = i, 0
        acc += n
    if acc or not sizes:
        spans.append((lo, len(sizes)))
    return spans


def plan_tile_chunks(n_tiles: int, floor: int = CAPACITY_FLOOR):
    """Split a decode batch of independent tiles into balanced chunks.

    Balancing (rather than greedy cap-sized chunks plus a remainder)
    keeps every chunk of an overflowing batch at or above half the cap,
    so overflow only ever lands in the top two classes — no
    small-residue classes appear under load that a prewarm pass didn't
    see.  -> chunk sizes.
    """
    cap = packing_cap(floor)
    if n_tiles <= cap:
        return [n_tiles] if n_tiles else []
    q = -(-n_tiles // cap)
    base, extra = divmod(n_tiles, q)
    return [base + (1 if i < extra else 0) for i in range(q)]


def record_batch(kind: str, n_real: int, capacity: int) -> None:
    with _LOCK:
        BUCKET_COUNTS[(kind, capacity)] += 1
        PAD_COUNTS["real"] += n_real
        PAD_COUNTS["padded"] += capacity - n_real


def reset_bucket_counts() -> None:
    with _LOCK:
        BUCKET_COUNTS.clear()
        PAD_COUNTS.clear()


def pad_waste() -> float:
    """Padded tiles per real tile since the last reset (0.0 when idle)."""
    real = PAD_COUNTS["real"]
    return PAD_COUNTS["padded"] / real if real else 0.0
