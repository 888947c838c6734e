"""Published peaks of the cards the benchmark runs on, and the least
time of a request's work at them.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): HBM3 at 3.35 TB/s.  The
share is stated against this peak whatever the card's power limit;
PERF.md gives the limit beside every number.
"""
from __future__ import annotations

PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}


def peak(device_name: str) -> dict | None:
    return next((v for k, v in PEAKS.items() if k in device_name), None)


def least_seconds(raw_bytes: int, container_bytes: int, device_name: str) -> float | None:
    """The least time a compress or decompress of one field can take on
    the card: the raw field read (or written) once and the container
    written (or read) once, at the memory's peak bandwidth."""
    p = peak(device_name)
    if p is None:
        return None
    return (raw_bytes + container_bytes) / p["hbm_bytes_per_s"]
