"""The device trace of a few requests, and its reduction.

``capture`` runs a function under ``torch.profiler`` (device activity
alone, so the host runs as it does untraced) and returns the trace as
plain tuples on the host's epoch clock in microseconds, which is the
clock of the program's spans: a one-element marker kernel launched on an
idle device just after a known epoch time gives the offset, to within
its launch latency (microseconds).  ``reduce`` turns those tuples and
the spans into the numbers the per-layer readers and the result's
``breakdown`` take.  It needs no card, so the tests feed it made-up
traces.
"""
from __future__ import annotations

import time

COPY = "Memcpy"


def capture(fn):
    """Run ``fn`` under the profiler -> (events, start_us, end_us):
    events are (name, start_us, end_us) of device activity (kernels,
    copies, memsets) on the epoch clock, the marker left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start_us = time.time_ns() / 1e3
        mark.fill_(1.0)  # the trace's first device event
        fn()
        torch.cuda.synchronize()
        end_us = time.time_ns() / 1e3
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == cuda and not e.name.startswith("Activity Buffer")),
                 key=lambda ev: ev[1])
    if not dev:
        return [], start_us, end_us
    offset = start_us - dev[0][1]
    return [(n, s + offset, e + offset) for n, s, e in dev[1:]], start_us, end_us


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Merged [start, end) intervals clipped to [lo, hi)."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def innermost(spans, t: float) -> str:
    """Name of the shortest span that covers host time ``t``."""
    best = None
    for s in spans:
        if s["ts_us"] <= t < s["ts_us"] + s["dur_us"]:
            if best is None or s["dur_us"] < best["dur_us"]:
                best = s
    return best["name"] if best else "harness"


def idle_pieces(gaps, spans) -> list[tuple[float, str]]:
    """The idle gaps cut where the host's innermost span changes ->
    [(microseconds, span name)], a piece for each stretch of one gap
    inside one span, adjacent stretches of one name joined."""
    out = []
    for lo, hi in gaps:
        live = [s for s in spans if s["ts_us"] < hi and s["ts_us"] + s["dur_us"] > lo]
        cuts = sorted({lo, hi, *(t for s in live for t in (s["ts_us"], s["ts_us"] + s["dur_us"])
                                 if lo < t < hi)})
        pieces = []
        for a, b in zip(cuts, cuts[1:]):
            name = innermost(live, (a + b) / 2)
            if pieces and pieces[-1][1] == name:
                pieces[-1][0] += b - a
            else:
                pieces.append([b - a, name])
        out.extend((us, name) for us, name in pieces)
    return sorted(out, key=lambda p: -p[0])


def reduce(events, start_us: float, end_us: float, spans, top: int = 10) -> dict:
    """Device busy and idle time over [start_us, end_us), kernel time
    (kernels and memsets; copies left out), the device operations that
    took most time and the longest idle stretches, each named by the
    innermost span the host was in."""
    busy = union([(s, e) for _, s, e in events], start_us, end_us)
    busy_us = sum(e - s for s, e in busy)
    kernel_us = sum(min(e, end_us) - max(s, start_us) for n, s, e in events
                    if not n.startswith(COPY) and min(e, end_us) > max(s, start_us))
    by_name: dict[str, float] = {}
    for n, s, e in events:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [start_us] + [t for seg in busy for t in seg] + [end_us]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return {
        "window_us": end_us - start_us,
        "busy_us": busy_us,
        "kernel_us": kernel_us,
        "device_ops": [[n[:120], us / 1e6] for n, us in ops],
        "idle_gaps": [[name, us / 1e6] for us, name in idle_pieces(gaps, spans)[:top]],
    }
