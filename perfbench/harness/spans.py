"""Per-request arithmetic over the program's spans, for the readers in
``metrics/``.

A traced request is the harness's ``bench.request`` span and every span
of its trace: the engine's groups and the executor's ``exec.*`` stages.
A stage nested in another stage (``exec.compaction`` inside
``exec.download``) is part of its parent's time and is not added again.
"""
from __future__ import annotations

ROOT = "bench.request"


def requests(spans, op: str) -> list[tuple[dict, list[dict]]]:
    """(root span, its trace's other spans) of every traced request of
    kind ``op``, in order."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    out = []
    for members in by_trace.values():
        root = next((s for s in members if s["name"] == ROOT), None)
        if root is not None and root["tags"].get("op") == op:
            out.append((root, [s for s in members if s is not root]))
    out.sort(key=lambda r: r[0]["ts_us"])
    return out


def top_stages(members: list[dict]) -> list[dict]:
    """``exec.*`` spans whose parent is not itself an ``exec.*`` span."""
    names = {s["span_id"]: s["name"] for s in members}
    return [s for s in members if s["name"].startswith("exec.")
            and not names.get(s["parent_id"], "").startswith("exec.")]


def stage_ms(spans, op: str, stages) -> float | None:
    """Mean milliseconds per request spent in the named top-level stages;
    None when no request of kind ``op`` was traced."""
    reqs = requests(spans, op)
    if not reqs:
        return None
    total = sum(s["dur_us"] for _, m in reqs for s in top_stages(m)
                if s["name"] in stages)
    return total / len(reqs) / 1e3


def host_ms(spans, op: str) -> float | None:
    """Mean milliseconds per request outside every top-level stage: the
    engine's own host work (plan, tiling, serialization or parsing and
    assembly) and the calls between stages."""
    reqs = requests(spans, op)
    if not reqs:
        return None
    total = sum(r["dur_us"] - sum(s["dur_us"] for s in top_stages(m))
                for r, m in reqs)
    return total / len(reqs) / 1e3
