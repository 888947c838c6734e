"""The port's observability (``repro_torch.obs``) against the JAX
reference's on the CPU.

The trace core is held to the reference's contracts (the span tree and
ambient context, error status, wire inject and extract, the no-op when
disabled); the port's counters lose no increment from 8 threads; the
registry's families after a small service run are the reference's; and
one traced service compress, decompress and store region read of a
small field validates against ``benchmarks/baselines/trace_schema.json``
in single-process mode under both packages' ``validate_trace``, with the
reference's (name, parent name) pairs for the same calls.
"""
from __future__ import annotations

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.engine.plan import CompressionPlan as RefPlan
from repro.service import CompressionService as RefService
from repro.service import ServiceConfig as RefConfig
from repro.store import LopcStore as RefStore
from repro_torch import obs
from repro_torch.engine import executor
from repro_torch.engine.plan import CompressionPlan
from repro_torch.kernels import _lib
from repro_torch.service import CompressionService, ServiceConfig
from repro_torch.store import LopcStore

PLAN = CompressionPlan(tile_shape=(8, 8, 8), batch_tiles=4)
REF_PLAN = RefPlan(tile_shape=(8, 8, 8), batch_tiles=4)
CFG = ServiceConfig(plan=PLAN, max_delay_ms=20.0, device="cpu")
REF_CFG = RefConfig(plan=REF_PLAN, max_delay_ms=20.0)
SCHEMA = json.loads(
    (Path(__file__).parent.parent / "benchmarks" / "baselines"
     / "trace_schema.json").read_text())
# benchmarks/check_trace.py --mode single drops these
_CLUSTER_PREFIXES = ("router.", "lprc.", "worker.")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Enable the port's tracing for one test; leave it dark afterwards."""
    obs.tracer().drain()
    obs.FLIGHT.clear()
    obs.enable()
    try:
        yield obs.tracer()
    finally:
        obs.disable()
        obs.FLIGHT.clear()


def _single_mode(schema: dict) -> dict:
    out = dict(schema)
    out["require_names"] = [n for n in schema.get("require_names", [])
                            if not n.startswith(_CLUSTER_PREFIXES)]
    out["nest_under"] = {k: v for k, v in (schema.get("nest_under") or {}).items()
                         if not k.startswith(_CLUSTER_PREFIXES)
                         and not k.startswith("router")}
    return out


def _small_field():
    return np.random.default_rng(4).standard_normal((16, 16, 12)).astype(
        np.float32)


# ------------------------------------------------------------ trace core

def test_disabled_tracing_is_noop():
    assert not obs.enabled()
    s1 = obs.span("a.b", x=1)
    s2 = obs.span("c.d")
    assert s1 is s2  # one shared no-op object, no allocation
    with s1 as sp:
        assert sp.set_tag("k", "v") is sp
        assert obs.context_of(sp) is None
    header = {"name": "f"}
    assert obs.inject(header) is header  # untouched, not copied
    obs.fence(np.zeros(3), torch.zeros(3), None)  # no sync point imposed
    assert obs.flight_dump("anything") is None
    assert obs.tracer().snapshot() == []


def test_span_tree_and_ambient_context(traced):
    with obs.span("outer", who="t") as outer:
        with obs.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            assert obs.current() == inner.context()
        assert obs.current() == outer.context()
    assert obs.current() is None
    spans = {s.name: s for s in traced.snapshot()}
    assert spans["outer"].parent_id is None
    assert spans["outer"].tags == {"who": "t"}
    assert spans["inner"].dur_us <= spans["outer"].dur_us
    # fence skips None and CPU tensors, and walks nested sequences
    obs.fence(None, torch.ones(2), [torch.ones(1), (None,)])


def test_error_sets_span_status(traced):
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("bad tile")
    (s,) = traced.snapshot()
    assert s.status == "ValueError" and s.tags["error"] == "bad tile"


def test_wire_context_roundtrip(traced):
    with obs.span("root") as sp:
        header = obs.inject({"name": "f", "tile_ids": [1, 2]})
        assert header["name"] == "f"  # payload keys untouched
        json.dumps(header)  # wire headers must stay JSON-clean
        ctx = obs.extract(header)
        assert ctx == sp.context()
    assert obs.extract({"name": "f"}) is None
    assert obs.extract({"_trace": "garbage"}) is None


# --------------------------------------------------------------- counters

@pytest.mark.parametrize("view", ["transfers", "decodes", "launches",
                                  "transform_launches"])
def test_counter_view_concurrent_increments_lose_nothing(view):
    """The executor's probes and the kernel launch counters, incremented
    from 8 threads at once, lose no update (a ``Counter``'s ``+=`` did)."""
    c = {"transfers": executor.TRANSFER_COUNTS,
         "decodes": executor.DECODE_COUNTS,
         "launches": _lib.LAUNCHES,
         "transform_launches": _lib.TRANSFORM_LAUNCHES}[view]
    key = f"concurrency_probe_{view}"
    n_threads, per_thread = 8, 2000

    def hammer():
        for _ in range(per_thread):
            c.add(key)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    try:
        assert c[key] == n_threads * per_thread
        assert isinstance(c[key], int) and dict(c)[key] == c[key]
        assert c["absent_key"] == 0 and "absent_key" not in c
    finally:
        del c[key]
    assert key not in c


def test_registry_families_equal_the_reference_after_service_traffic():
    """The process registry's exposition after one small service run
    holds the reference's family names, kinds and help texts."""
    x = _small_field()
    with CompressionService(CFG) as svc:
        svc.decompress(svc.compress(x, 1e-2))
    with RefService(REF_CFG) as rsvc:
        rsvc.decompress(rsvc.compress(x, 1e-2))

    def families(reg):
        return {f.name: (f.kind, f.help) for f in reg.families()}

    assert families(obs.REGISTRY) == families(ref_obs.REGISTRY)
    text = obs.REGISTRY.expose_text()
    assert "# TYPE lopc_transfers_total counter" in text
    assert "lopc_service_latency_seconds_bucket" in text
    # the launch counters stay out of the process registry
    assert "lopc_kernel_launches_total" not in text


# ------------------------------------------------------------- traces

def _traced_calls(svc, store, x, roi):
    blob = svc.compress(x, 1e-2)
    svc.decompress(blob)
    svc.store_write(store, "x", x, 1e-2)
    svc.store_roi(store, "x", roi)
    return blob


def _pairs(spans: list[dict]) -> set:
    by_id = {s["span_id"]: s["name"] for s in spans}
    return {(s["name"], by_id.get(s["parent_id"])) for s in spans}


def test_traced_service_run_validates_and_matches_the_reference(tmp_path):
    x = _small_field()
    roi = (slice(2, 11), slice(3, 12), slice(0, 7))

    obs.tracer().drain()
    obs.enable()
    try:
        store = LopcStore.create(tmp_path / "port", plan=PLAN, device="cpu")
        with CompressionService(CFG) as svc:
            blob = _traced_calls(svc, store, x, roi)
        store.close()
        doc = obs.write_trace(str(tmp_path / "port.json"),
                              obs.tracer().drain(), meta={"mode": "store"})
    finally:
        obs.disable()

    ref_obs.tracer().drain()
    ref_obs.enable()
    try:
        rstore = RefStore.create(tmp_path / "ref", plan=REF_PLAN)
        with RefService(REF_CFG) as rsvc:
            rblob = _traced_calls(rsvc, rstore, x, roi)
        rstore.close()
        ref_doc = ref_obs.write_trace(str(tmp_path / "ref.json"),
                                      ref_obs.tracer().drain())
    finally:
        ref_obs.disable()

    assert blob == rblob
    schema = _single_mode(SCHEMA)
    assert obs.validate_trace(doc, schema) == []
    on_disk = json.loads((tmp_path / "port.json").read_text())
    assert ref_obs.validate_trace(on_disk, schema) == []
    assert _pairs(doc["spans"]) == _pairs(ref_doc["spans"])
    # every executor stage nests under an engine group, under the
    # service's group, under one request per trace
    names = {s["name"] for s in doc["spans"]}
    assert {"service.request", "service.group", "engine.compress_group",
            "engine.decode_group", "store.read", "exec.upload",
            "exec.solve", "exec.encode", "exec.decode",
            "exec.download"} <= names


def test_chain_steps_open_no_stage_spans(traced):
    """As in the reference, a chain's steps open no ``exec.*`` spans (no
    engine group would parent them)."""
    from repro_torch import temporal

    frames = [np.random.default_rng(t).standard_normal((8, 8, 8))
              for t in range(2)]
    temporal.compress_chain(frames, 1e-2, plan=PLAN, device="cpu")
    assert traced.snapshot() == []


def test_poison_batch_leaves_isolation_spans_and_dump(traced):
    rng = np.random.default_rng(5)
    good = rng.standard_normal((8, 8, 8))
    bad = np.arange(512, dtype=np.int32).reshape(8, 8, 8)
    svc = CompressionService(CFG, autostart=False)
    try:
        fg = svc.submit_compress(good, 1e-2)
        fb = svc.submit_compress(bad, 1e-2)
        svc.start()
        fg.result(timeout=300)
        with pytest.raises(ValueError):
            fb.result(timeout=300)
    finally:
        svc.stop()
    spans = traced.drain()
    retries = [s for s in spans if s.name == "service.isolate_retry"]
    assert len(retries) == 2  # every member retried solo
    assert {s.trace_id for s in retries} == \
        {s.trace_id for s in spans if s.name == "service.request"}
    dumps = obs.FLIGHT.dumps("poison_isolation")
    assert dumps and dumps[0]["context"]["n_requests"] == 2
    fail_dumps = obs.FLIGHT.dumps("request_failure")
    failed = next(s for s in spans if s.name == "service.request"
                  and s.status != "ok")
    assert fail_dumps and fail_dumps[0]["trace_id"] == failed.trace_id


def test_flight_dump_writes_file_when_configured(tmp_path, traced):
    obs.FLIGHT.configure(directory=str(tmp_path / "flight"))
    try:
        with obs.span("op.failing") as sp:
            tid = sp.trace_id
        doc = obs.flight_dump("unit_test", trace_id=tid, detail=7)
        assert doc["path"] and Path(doc["path"]).exists()
        on_disk = json.loads(Path(doc["path"]).read_text())
        assert on_disk["reason"] == "unit_test"
        assert on_disk["context"] == {"detail": 7}
        assert [s["name"] for s in on_disk["trace_spans"]] == ["op.failing"]
    finally:
        obs.FLIGHT._dir = None  # don't leak the tmp dir to later tests


def test_validate_trace_catches_structural_breaks():
    def mk(name, sid, parent, tid="t1"):
        return {"name": name, "trace_id": tid, "span_id": sid,
                "parent_id": parent, "ts_us": 1, "dur_us": 1,
                "status": "ok", "pid": 1, "tags": {}}

    ok_doc = {"traceEvents": [], "spans": [
        mk("service.request", "a", None),
        mk("engine.decode_group", "b", "a"),
        mk("exec.decode", "c", "b"),
    ]}
    assert obs.validate_trace(ok_doc, {"nest_under": {"exec.": "engine."}}) \
        == []
    bad = {"traceEvents": [], "spans": [
        mk("service.request", "a", None),
        mk("exec.decode", "c", "missing"),
        mk("orphan.root", "d", None),
    ]}
    errs = obs.validate_trace(bad, {"nest_under": {"exec.": "engine."}})
    assert any("parent missing not found" in e for e in errs)
    assert any("2 roots" in e for e in errs)
    assert any("no engine.* ancestor" in e for e in errs)
    assert obs.validate_trace({"spans": []}, {}) == ["document has no spans"]
