"""Trace export and structural validation (a copy of
``repro.obs.export``).

:func:`write_trace` emits a Chrome-trace/Perfetto-loadable JSON file:
the standard ``traceEvents`` array of complete (``"ph": "X"``) events,
plus two extra top-level keys Perfetto ignores — ``spans`` (the raw
span dicts, the lossless form the validator and tests consume) and
``meta``.  Track mapping: ``pid`` is the originating process and each
trace gets its own ``tid`` lane, so a cross-process cluster trace
renders as one aligned timeline per process.

:func:`validate_trace` is the CI-schema check: referential integrity
(every non-root parent id resolves inside the same trace), exactly one
root per trace, executor stage spans (``exec.*``) nested somewhere
under an engine group span (``engine.*``), and non-negative timings.
``benchmarks/check_trace.py`` drives it against
``benchmarks/baselines/trace_schema.json``.
"""
from __future__ import annotations

import json


def _span_dicts(spans) -> list[dict]:
    out = []
    for s in spans:
        out.append(s if isinstance(s, dict) else s.as_dict())
    return out


def spans_to_chrome(spans) -> list[dict]:
    """Map span dicts to Chrome trace complete events."""
    dicts = _span_dicts(spans)
    # one display lane per trace so concurrent requests don't overlap
    lanes: dict[str, int] = {}
    events = []
    for d in dicts:
        lane = lanes.setdefault(d["trace_id"], len(lanes) + 1)
        events.append({
            "ph": "X",
            "name": d["name"],
            "ts": d["ts_us"],
            "dur": max(int(d["dur_us"]), 1),
            "pid": d.get("pid", 0),
            "tid": lane,
            "cat": d["name"].split(".", 1)[0],
            "args": {
                "trace_id": d["trace_id"],
                "span_id": d["span_id"],
                "parent_id": d.get("parent_id"),
                "status": d.get("status", "ok"),
                **(d.get("tags") or {}),
            },
        })
    return events


def write_trace(path: str, spans, meta: dict | None = None) -> dict:
    """Write spans as a Perfetto-loadable trace file; returns the doc."""
    dicts = _span_dicts(spans)
    doc = {
        "traceEvents": spans_to_chrome(dicts),
        "displayTimeUnit": "ms",
        "spans": dicts,
        "meta": dict(meta or {}),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def validate_trace(doc: dict, schema: dict | None = None) -> list[str]:
    """Structurally validate a trace document; returns error strings
    (empty list == valid).

    ``schema`` mirrors ``benchmarks/baselines/trace_schema.json``:

    * ``required_span_fields`` — keys every span must carry,
    * ``single_root_per_trace`` — each trace has exactly one root,
    * ``nest_under`` — ``{"exec.": "engine."}``-style prefix pairs: a
      span whose name starts with the key must have an ancestor whose
      name starts with the value,
    * ``require_names`` — span-name prefixes that must appear at least
      once somewhere in the document.
    """
    schema = schema or {}
    errors: list[str] = []
    spans = doc.get("spans")
    if not isinstance(spans, list) or not spans:
        return ["document has no spans"]
    if not isinstance(doc.get("traceEvents"), list):
        errors.append("document has no traceEvents")

    required = schema.get(
        "required_span_fields",
        ["name", "trace_id", "span_id", "ts_us", "dur_us"])
    by_id: dict[str, dict] = {}
    by_trace: dict[str, list] = {}
    for i, s in enumerate(spans):
        for field in required:
            if field not in s:
                errors.append(f"span[{i}] missing field {field!r}")
        sid = s.get("span_id")
        if sid in by_id:
            errors.append(f"duplicate span_id {sid}")
        if sid is not None:
            by_id[sid] = s
        by_trace.setdefault(s.get("trace_id"), []).append(s)
        if s.get("dur_us", 0) < 0 or s.get("ts_us", 0) < 0:
            errors.append(f"span[{i}] ({s.get('name')}) negative timing")

    # referential integrity + root count per trace
    for tid, members in by_trace.items():
        roots = []
        ids = {m["span_id"] for m in members if "span_id" in m}
        for m in members:
            pid = m.get("parent_id")
            if pid is None:
                roots.append(m)
            elif pid not in ids:
                errors.append(
                    f"span {m.get('name')} ({m.get('span_id')}) parent "
                    f"{pid} not found in trace {tid}")
        if schema.get("single_root_per_trace", True) and len(roots) != 1:
            errors.append(
                f"trace {tid} has {len(roots)} roots "
                f"({[r.get('name') for r in roots]}), expected 1")

    # nesting constraints: child-prefix must sit under ancestor-prefix
    for child_pfx, anc_pfx in (schema.get("nest_under") or {}).items():
        for s in spans:
            if not str(s.get("name", "")).startswith(child_pfx):
                continue
            node, seen, ok = s, set(), False
            while True:
                pid = node.get("parent_id")
                if pid is None or pid in seen or pid not in by_id:
                    break
                seen.add(pid)
                node = by_id[pid]
                if str(node.get("name", "")).startswith(anc_pfx):
                    ok = True
                    break
            if not ok:
                errors.append(
                    f"span {s.get('name')} ({s.get('span_id')}) has no "
                    f"{anc_pfx}* ancestor")

    # coverage: these name prefixes must appear somewhere
    names = [str(s.get("name", "")) for s in spans]
    for pfx in schema.get("require_names") or []:
        if not any(n.startswith(pfx) for n in names):
            errors.append(f"no span named {pfx}* in document")

    return errors
