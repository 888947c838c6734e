"""The harness's arithmetic on made-up windows, spans and traces: rates,
self time, stage time, idle share, roofline share and gap naming."""
import pytest

from perfbench.harness import peaks, profile, spans, spec
from perfbench.harness.run import RunRecord, Window


def _span(name, sid, parent, ts, dur, trace="t1", **tags):
    return {"name": name, "span_id": sid, "parent_id": parent, "trace_id": trace,
            "ts_us": ts, "dur_us": dur, "tags": tags}


def _record(op="compress", requests=(), spans_=(), prof=None, counters=None):
    win = Window(op, t0=10.0, t_last=14.0, requests=list(requests))
    return RunRecord(None, 12.5, win, list(spans_), prof, counters or {})


def test_rate_is_all_bytes_over_all_window_time():
    reqs = [{"raw_bytes": 100_000_000, "container_bytes": 20_000_000}] * 3
    rec = _record(requests=reqs)
    assert spec.reader("compress_MBps")(rec) == pytest.approx(300 / 4.0)
    assert spec.reader("decompress_MBps")(rec) is None
    assert spec.reader("setup_s")(rec) == 12.5
    assert spec.reader("d2h_per_container.write")(
        _record(requests=reqs, counters={"bytes_d2h": 66_000_000})) == pytest.approx(1.1)


def _request(trace, t0):
    # a 1000 us request: upload 100, solve 50, download 200 holding a
    # compaction of 150 that must not be counted twice
    return [_span("bench.request", f"{trace}r", None, t0, 1000, trace, op="compress"),
            _span("engine.compress_group", f"{trace}g", f"{trace}r", t0 + 10, 900, trace),
            _span("exec.upload", f"{trace}u", f"{trace}g", t0 + 20, 100, trace),
            _span("exec.solve", f"{trace}s", f"{trace}g", t0 + 130, 50, trace),
            _span("exec.download", f"{trace}d", f"{trace}g", t0 + 200, 200, trace),
            _span("exec.compaction", f"{trace}c", f"{trace}d", t0 + 210, 150, trace)]


def test_stage_and_self_time_per_request():
    sp = _request("a", 0) + _request("b", 5000)
    assert spans.stage_ms(sp, "compress", ("exec.upload", "exec.download")) == pytest.approx(0.3)
    assert spans.stage_ms(sp, "compress", ("exec.solve",)) == pytest.approx(0.05)
    assert spans.host_ms(sp, "compress") == pytest.approx(0.65)
    assert spans.host_ms(sp, "decompress") is None
    rec = _record(spans_=sp)
    assert spec.reader("engine_host_ms.write")(rec) == pytest.approx(0.65)
    assert spec.reader("transfer_ms.write")(rec) == pytest.approx(0.3)


def test_busy_union_idle_share_and_gap_names():
    events = [("kern_a", 100, 300), ("Memcpy HtoD (Pageable -> Device)", 250, 400),
              ("kern_b", 600, 700), ("Memset (Device)", 690, 720), ("kern_a", 900, 950)]
    sp = _request("a", 0)
    p = profile.reduce(events, 0, 1000, sp)
    assert p["busy_us"] == pytest.approx(300 + 120 + 50)
    assert p["kernel_us"] == pytest.approx(200 + 100 + 30 + 50)
    assert p["device_ops"][0] == ["kern_a", pytest.approx(250e-6)]
    # idle: [0,100) [400,600) [720,900) [950,1000), cut by the spans
    assert sum(us for _, us in p["idle_gaps"]) == pytest.approx(530e-6)
    names = dict((round(us * 1e6), n) for n, us in p["idle_gaps"])
    assert names[200] == "engine.compress_group"  # [400, 600) after the download
    rec = _record(prof=dict(p, requests=1, raw_bytes=10**8, container_bytes=2 * 10**7,
                            device_name="NVIDIA H100 80GB HBM3"))
    assert spec.reader("device_idle_share.write")(rec) == pytest.approx(100 * 530 / 1000)
    share = spec.reader("kernels_roofline.write")(rec)
    assert share == pytest.approx(100 * (1.2e8 / 3.35e12) / 380e-6)
    assert spec.reader("kernels_roofline.read")(rec) is None


def test_union_clips_and_merges():
    assert profile.union([(5, 8), (0, 3), (2, 4), (9, 20)], 1, 10) == [(1, 4), (5, 8), (9, 10)]


def test_least_time_needs_a_known_card():
    assert peaks.least_seconds(10**9, 0, "NVIDIA H100 80GB HBM3") == pytest.approx(1e9 / 3.35e12)
    assert peaks.least_seconds(10**9, 0, "some other card") is None
