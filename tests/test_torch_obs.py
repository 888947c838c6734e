"""The port's observability (``repro_torch.obs``) against the JAX
reference's on the CPU.

The trace core is held to the reference's contracts (the span tree and
ambient context, error status, wire inject and extract, the no-op when
disabled); the port's counters lose no increment from 8 threads; the
registry's families after a small service run are the reference's; and
one traced service compress, decompress and store region read of a
small field validates against ``benchmarks/baselines/trace_schema.json``
in single-process mode under both packages' ``validate_trace``, with the
reference's (name, parent name) pairs for the same calls and the port's
own host spans beside them.  The port's spans of the engine's host work
and its stages' CUDA event pairs (``obs.stage``) are held to their
contract: every span under its parent, nothing recorded with tracing
off, no event on the CPU, ``device_us`` resolved only when the spans are
handed out, and ``bytes_h2d_pad`` counting the pad rows' bytes.
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
from repro_torch import engine, obs
from repro_torch.engine import executor, halo
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
    # a stage is the same no-op, whatever its device: no event recorded
    assert obs.stage("exec.solve", torch.device("cpu"), tiles=3) is s1
    assert obs.stage("exec.decode", "cuda:0") is s1
    assert obs.stage("exec.upload", "cpu") is s1
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
    # a stage on the CPU is a plain span under the ambient context: no
    # event, so no device time
    with obs.span("group") as group:
        with obs.stage("exec.cpu", torch.device("cpu"), tiles=2) as st:
            assert st._events is None
            assert st.parent_id == group.span_id
    (st,) = [s for s in traced.snapshot() if s.name == "exec.cpu"]
    assert st.tags == {"tiles": 2} and st.as_dict()["tags"] == {"tiles": 2}


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


# (name, parent name) pairs of the port's spans of the engine's host work,
# which the reference does not open, in the traced service run below
PORT_ONLY = {
    ("engine.plan", "service.group"),
    ("engine.tile", "engine.compress_group"),
    ("engine.serialize", "engine.compress_group"),
    ("exec.restore", "exec.download"),
    ("engine.parse", "service.group"),
    ("engine.parse", "store.read"),
    ("engine.assemble", "service.group"),
}


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
    port, ref = _pairs(doc["spans"]), _pairs(ref_doc["spans"])
    assert ref <= port
    assert port - ref == PORT_ONLY
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


# a field of 6x6x6 tiles of (4, 4, 4): 216 tiles, not a capacity class
# (its compress batch pads to 256), and more than the 128 a decode
# batch holds, so ``exec.pad`` and ``exec.concat`` open
SPAN_PLAN = CompressionPlan(tile_shape=(4, 4, 4), batch_tiles=8)
SPAN_SHAPE = (24, 24, 24)

COMPRESS_SPANS = {  # name -> parent name, one compress request
    "engine.plan": "test.request",
    "engine.compress_group": "test.request",
    "engine.tile": "engine.compress_group",
    "exec.pad": "engine.compress_group",
    "exec.upload": "engine.compress_group",
    "exec.solve": "engine.compress_group",
    "exec.encode": "engine.compress_group",
    "exec.download": "engine.compress_group",
    "exec.compaction": "exec.download",
    "exec.restore": "exec.download",
    "engine.serialize": "engine.compress_group",
}
DECOMPRESS_SPANS = {  # a whole field or a region read back
    "engine.parse": "test.request",
    "engine.decode_group": "test.request",
    "exec.stream_prep": "engine.decode_group",
    "exec.decode": "engine.decode_group",
    "exec.download": "engine.decode_group",
    "exec.concat": "engine.decode_group",
    "engine.assemble": "test.request",
}


def _span_field():
    return np.random.default_rng(6).standard_normal(SPAN_SHAPE).astype(np.float32)


def _request(fn, **tags):
    """Run ``fn`` under a root span -> (its value, {name: [(span, parent
    name)]} of the trace)."""
    obs.tracer().drain()
    with obs.span("test.request", **tags):
        out = fn()
    spans = obs.tracer().drain()
    assert len({s.trace_id for s in spans}) == 1  # one trace a request
    names = {s.span_id: s.name for s in spans}
    tree: dict[str, list] = {}
    for s in spans:
        tree.setdefault(s.name, []).append((s, names.get(s.parent_id)))
    return out, tree


def _assert_tree(tree, expected):
    got = {name for name in tree if name != "test.request"}
    assert got == set(expected)
    for name, parent in expected.items():
        assert {p for _, p in tree[name]} == {parent}, name
        for s, _ in tree[name]:
            assert s.status == "ok" and "device_us" not in s.tags  # the CPU


def test_engine_host_spans_under_their_parents(traced):
    """A traced compress (fused download) and its decompress, region read
    and tile decode on the CPU open every span of the engine's host work
    under its parent, each tagged with its work; tracing off records no
    span and writes the same bytes."""
    x = _span_field()
    region = (slice(4, 20), slice(0, 24), slice(1, 23))  # 144 tiles

    def run():
        blob = engine.compress(x, 1e-2, plan=SPAN_PLAN, encode_path="fused",
                               device="cpu")
        return blob, engine.decompress(blob, plan=SPAN_PLAN, device="cpu")

    blob, tree = _request(lambda: engine.compress(
        x, 1e-2, plan=SPAN_PLAN, encode_path="fused", device="cpu"))
    _assert_tree(tree, COMPRESS_SPANS)
    (plan, _), = tree["engine.plan"]
    assert plan.tags == {"fields": 1, "tiles": 216, "nbytes_in": x.nbytes}
    (tile, _), = tree["engine.tile"]
    assert tile.tags["tiles"] == 216
    (pad, _), = tree["exec.pad"]
    assert pad.tags == {"tiles": 216, "rows": 40}
    (ser, _), = tree["engine.serialize"]
    assert ser.tags == {"fields": 1, "tiles": 216, "nbytes_out": len(blob)}
    assert {s.tags["streams"] for s, _ in tree["exec.restore"]} == {2}

    y, tree = _request(lambda: engine.decompress(blob, plan=SPAN_PLAN,
                                                 device="cpu"))
    _assert_tree(tree, DECOMPRESS_SPANS)
    assert len(tree["engine.parse"]) == 2  # the container, the work list
    assert len(tree["exec.decode"]) == 2
    (cat, _), = tree["exec.concat"]
    assert cat.tags == {"batches": 2, "tiles": 216}
    (asm, _), = tree["engine.assemble"]
    assert asm.tags == {"fields": 1, "nbytes_out": y.nbytes}

    box, tree = _request(lambda: engine.decompress_roi(
        blob, region, plan=SPAN_PLAN, device="cpu"))
    assert np.array_equal(box, y[region])
    _assert_tree(tree, DECOMPRESS_SPANS)
    (asm, _), = tree["engine.assemble"]
    assert asm.tags["nbytes_out"] == box.nbytes

    tiles, tree = _request(lambda: engine.decode_tiles_many(
        [(blob, [0, 5])], plan=SPAN_PLAN, device="cpu"))
    assert {s.tags["tiles"] for s, _ in tree["engine.parse"]} == {2}
    assert set(tree) == {"test.request", "engine.parse", "engine.decode_group",
                         "exec.stream_prep", "exec.decode", "exec.download"}

    obs.disable()
    obs.FLIGHT.clear()
    blob_off, y_off = run()
    assert blob_off == blob and np.array_equal(y_off, y)
    assert obs.tracer().snapshot() == [] and obs.FLIGHT.events() == []


def test_pad_bytes_count_the_pad_rows_of_every_row_upload():
    """``bytes_h2d_pad`` is the pad rows' share of ``bytes_h2d``: 40 of a
    batch's 256 rows of haloed tiles, eps, halo index and mask, for a
    layout of 216 tiles (not a capacity class)."""
    x = _span_field()
    layout = SPAN_PLAN.layout_for(x.shape)
    capacity = executor.resident_capacity(layout.n_tiles)
    assert (layout.n_tiles, capacity) == (216, 256)
    idx, mask = halo.group_index((layout,), capacity)
    haloed = int(np.prod([t + 2 * halo.HALO for t in layout.tile]))
    row = haloed * x.itemsize + 8 + idx[0].nbytes + mask[0].nbytes
    executor.reset_transfer_counts()
    engine.compress(x, 1e-2, plan=SPAN_PLAN, device="cpu")
    pad = executor.TRANSFER_COUNTS["bytes_h2d_pad"]
    assert pad == (capacity - layout.n_tiles) * row
    assert 0 < pad < executor.TRANSFER_COUNTS["bytes_h2d"]
    # a whole capacity class uploads no pad row
    executor.reset_transfer_counts()
    engine.compress(x[:16, :16, :8], 1e-2, plan=SPAN_PLAN, device="cpu")
    assert executor.TRANSFER_COUNTS["bytes_h2d_pad"] == 0
    assert executor.TRANSFER_COUNTS["bytes_h2d"] > 0


class _FakeEvent:
    """A CUDA event's surface on a made-up clock (ms): ``record`` reads
    the next tick, and the test sees whether anyone waited."""

    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.waited = False

    def record(self, stream=None):
        assert stream == "stream0"
        _FakeEvent.clock += 1.25
        self.t = _FakeEvent.clock

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        assert self.t is not None and end.t is not None
        return end.t - self.t


def test_stage_events_resolve_only_when_handed_out(traced, monkeypatch):
    """On a CUDA device a stage records one event at each edge on the
    current stream and waits for neither while it runs; the flight
    recorder's copy at finish has no ``device_us``; the tracer's hand-out
    (``snapshot``/``drain``/``take``/``as_dict``) and a dump resolve the
    pair into ``device_us``, the end's time after the start's in us."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream0")
    with obs.span("engine.decode_group") as group:
        tid = group.trace_id
        with obs.stage("exec.decode", torch.device("cuda"), tiles=4) as st:
            start = st._events[0]
            with obs.stage("exec.download", "cuda:0") as inner:
                pass
        end = st._events[1]
    assert not start.waited and not end.waited  # nothing synchronized
    (evt,) = [e for e in obs.FLIGHT.events() if e["name"] == "exec.decode"]
    assert evt["tags"] == {"tiles": 4}
    doc = obs.flight_dump("unit_test", trace_id=tid)
    by_name = {d["name"]: d for d in doc["trace_spans"]}
    assert by_name["exec.decode"]["tags"] == {"tiles": 4, "device_us": 3750.0}
    assert by_name["exec.download"]["tags"] == {"device_us": 1250.0}
    assert "device_us" not in by_name["engine.decode_group"]["tags"]
    assert end.waited and st._events is None and inner._events is None
    # resolved once: handing the spans out again reads the same tags
    taken = {s.name: s for s in traced.take(tid)}
    assert taken["exec.decode"].tags["device_us"] == 3750.0
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
