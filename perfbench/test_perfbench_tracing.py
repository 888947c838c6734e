"""The readers of the program's finer spans on made-up traces: named host
steps, a stage nested in another, device time from ``device_us``, the
part of a request no span covers when spans overlap, the pad share, and
``None`` from a program that opens none of these spans."""
import pytest

from perfbench.harness import host_spans, spec
from perfbench.harness.run import RunRecord, Window


def _span(name, sid, parent, ts, dur, trace="t1", **tags):
    return {"name": name, "span_id": sid, "parent_id": parent, "trace_id": trace,
            "ts_us": ts, "dur_us": dur, "tags": tags}


def _record(op="compress", spans_=(), counters=None):
    return RunRecord(None, 1.0, Window(op), list(spans_), None, counters or {})


def _write(trace, t0, device=True):
    """A 1000 us compress request: plan 100, the group 880 holding tile
    150, pad 50, upload 80, solve 60 (device 200 when timed), a download
    of 200 holding a restore of 120, and serialize 300; 60 us nowhere."""
    dev = {"device_us": 200.0} if device else {}
    g = f"{trace}g"
    return [_span("bench.request", f"{trace}r", None, t0, 1000, trace, op="compress"),
            _span("engine.plan", f"{trace}p", f"{trace}r", t0 + 10, 100, trace),
            _span("engine.compress_group", g, f"{trace}r", t0 + 120, 880, trace),
            _span("engine.tile", f"{trace}t", g, t0 + 130, 150, trace),
            _span("exec.pad", f"{trace}a", g, t0 + 280, 50, trace),
            _span("exec.upload", f"{trace}u", g, t0 + 330, 80, trace),
            _span("exec.solve", f"{trace}s", g, t0 + 410, 60, trace, **dev),
            _span("exec.download", f"{trace}d", g, t0 + 470, 200, trace),
            _span("exec.restore", f"{trace}x", f"{trace}d", t0 + 550, 120, trace),
            _span("engine.serialize", f"{trace}z", g, t0 + 700, 300, trace)]


def _read(trace, t0):
    """A 1000 us decompress request whose parse (0-300) and work list
    (250-350) overlap, then a group holding a decode (device 40) and a
    concat of 100, then an assemble of 200; 150 us nowhere."""
    g = f"{trace}g"
    return [_span("bench.request", f"{trace}r", None, t0, 1000, trace, op="decompress"),
            _span("engine.parse", f"{trace}p", f"{trace}r", t0, 300, trace),
            _span("engine.parse", f"{trace}q", f"{trace}r", t0 + 250, 100, trace),
            _span("engine.decode_group", g, f"{trace}r", t0 + 350, 400, trace),
            _span("exec.decode", f"{trace}e", g, t0 + 400, 200, trace, device_us=40.0),
            _span("exec.concat", f"{trace}c", g, t0 + 600, 100, trace),
            _span("engine.assemble", f"{trace}m", f"{trace}r", t0 + 800, 200, trace)]


def test_host_steps_and_nested_restore_per_request():
    rec = _record(spans_=_write("a", 0) + _write("b", 5000))
    assert spec.reader("plan_ms.write")(rec) == pytest.approx(0.1)
    assert spec.reader("tiling_ms.write")(rec) == pytest.approx(0.2)
    assert spec.reader("serialize_ms.write")(rec) == pytest.approx(0.3)
    # exec.restore is nested in exec.download and still read
    assert spec.reader("restore_ms.write")(rec) == pytest.approx(0.12)
    # the restore sits inside the download: the union counts it once
    assert spec.reader("unattributed_ms.write")(rec) == pytest.approx(0.06)
    assert spec.reader("solve_device_ms.write")(rec) == pytest.approx(0.2)
    # a decompress reader finds no request of its kind
    assert spec.reader("parse_ms.read")(rec) is None
    assert spec.reader("unattributed_ms.read")(rec) is None


def test_self_time_with_overlapping_children():
    rec = _record("decompress", _read("a", 0) + _read("b", 3000))
    assert spec.reader("parse_ms.read")(rec) == pytest.approx(0.4)
    assert spec.reader("assemble_ms.read")(rec) == pytest.approx(0.3)
    assert spec.reader("decode_device_ms.read")(rec) == pytest.approx(0.04)
    # covered: [0, 350) by the two parses, [400, 700) by the stages,
    # [800, 1000) by the assemble; the group itself names nothing
    assert spec.reader("unattributed_ms.read")(rec) == pytest.approx(0.15)
    assert host_spans.unattributed_ms(rec.spans, "decompress") == pytest.approx(0.15)


def test_a_span_past_the_request_is_clipped():
    sp = _read("a", 0)
    sp[-1] = _span("engine.assemble", "am", "ar", 800, 400, "a")  # runs 200 us past the root
    assert host_spans.unattributed_ms(sp, "decompress") == pytest.approx(0.15)


def test_device_us_absent_returns_none():
    # a CPU run, or a program whose stages carry no device time
    rec = _record(spans_=_write("a", 0, device=False))
    assert spec.reader("solve_device_ms.write")(rec) is None
    mixed = _write("a", 0) + _write("b", 5000, device=False)
    assert host_spans.device_ms(mixed, "compress", "exec.solve") is None
    assert spec.reader("decode_device_ms.read")(_record("decompress")) is None


def test_a_program_without_the_spans_reads_none():
    # the parent program: the groups and the executor's stages alone
    old = [s for s in _write("a", 0)
           if s["name"] in ("bench.request", "engine.compress_group", "exec.upload",
                            "exec.solve", "exec.download")]
    for s in old:
        s["tags"].pop("device_us", None)
    rec = _record(spans_=old)
    for name in ("plan_ms.write", "tiling_ms.write", "serialize_ms.write",
                 "restore_ms.write", "solve_device_ms.write"):
        assert spec.reader(name)(rec) is None, name
    # what no span covers is still defined: 1000 - 80 - 60 - 200 us
    assert spec.reader("unattributed_ms.write")(rec) == pytest.approx(0.66)


def test_pad_share_from_the_counters():
    read = spec.reader("pad_share.write")
    rec = _record(counters={"bytes_h2d": 8_000, "bytes_h2d_pad": 1_000})
    assert read(rec) == pytest.approx(12.5)
    assert read(_record(counters={"bytes_h2d": 8_000})) is None  # no such counter
    assert read(_record(counters={"bytes_h2d_pad": 0})) is None
    assert read(_record("decompress", counters={"bytes_h2d": 8_000,
                                                "bytes_h2d_pad": 1_000})) is None
