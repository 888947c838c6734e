"""The port's compression service (``repro_torch.service``) and its
launcher against the JAX reference on the CPU.

Each case follows ``tests/test_service.py`` on the port
(``ServiceConfig(device="cpu")``): concurrent mixed requests coalesce
into shared batches and device groups and give the bytes of a direct
``engine.compress``, which are the reference's; the ``group_cb`` dicts
of the engine and the chains equal the reference's; backpressure,
poison isolation, stop without drain, cancelled futures, the asyncio
facade, store requests and the cache metrics, chains in bucket company,
the encode and decode paths, the steady state of ``trace_count``; and
``python -m repro_torch.launch.serve --store --trace-out`` and ``--cluster
2 --trace-out`` run as subprocesses whose traces validate (the cluster's
in cluster mode, from the router's and the workers' processes).  Batches are made deterministic by
queueing against a stopped worker, then starting it.
"""
from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import engine as ref_engine
from repro import temporal as ref_temporal
from repro.engine.plan import CompressionPlan as RefPlan
from repro.obs import validate_trace as ref_validate_trace
from repro_torch import engine, obs, temporal
from repro_torch.engine import device
from repro_torch.engine.plan import CompressionPlan, tiles_for_region
from repro_torch.service import (
    CompressionService,
    ServiceConfig,
    ServiceOverloaded,
    percentile,
)
from repro_torch.store import LopcStore

REPO = Path(__file__).resolve().parents[1]
PLAN = CompressionPlan(tile_shape=(8, 8, 8), batch_tiles=4)
REF_PLAN = RefPlan(tile_shape=(8, 8, 8), batch_tiles=4)
CFG = ServiceConfig(plan=PLAN, solver="auto", max_delay_ms=25.0,
                    max_batch_requests=64, max_queue=64, device="cpu")
SHAPES = [(8, 8, 8), (7, 9, 8), (16, 8, 8), (9, 12, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_fields(seed, n=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPES[i % len(SHAPES)]).astype(
        np.float64 if i % 2 else np.float32) for i in range(n)]


@pytest.fixture(scope="module")
def mixed():
    """Six mixed fields and the reference's containers of them (one
    ``compress_many`` call: its bytes are each field's solo bytes)."""
    fields = _mixed_fields(1)
    return fields, ref_engine.compress_many(fields, 1e-2, plan=REF_PLAN)


def _queue_then_start(svc, submits):
    """Deterministic batch: enqueue everything, then start the worker."""
    futs = [fn(*args) for fn, *args in submits]
    svc.start()
    return [f.result(timeout=300) for f in futs]


def test_concurrent_mixed_requests_coalesce_byte_identical(mixed):
    fields, ref_blobs = mixed
    svc = CompressionService(CFG, autostart=False)
    try:
        blobs = _queue_then_start(
            svc, [(svc.submit_compress, x, 1e-2) for x in fields])
        m = svc.metrics()
        assert m.mean_batch_occupancy > 1
        assert m.max_batch_occupancy == len(fields)
        assert m.device_groups < len(fields)
        assert m.traces_added == 0
        for x, b, rb in zip(fields, blobs, ref_blobs):
            assert b == rb
            assert b == engine.compress(x, 1e-2, plan=PLAN, device="cpu")
        outs = _queue_then_start(svc, [(svc.submit_decompress, b)
                                       for b in blobs])
        roi = (slice(1, 5), slice(2, 7), slice(0, 8))
        sub = svc.submit_roi(blobs[0], roi).result()
        want = ref_engine.decompress_many(ref_blobs, plan=REF_PLAN)
        for y, w in zip(outs, want):
            assert y.dtype == w.dtype and y.tobytes() == w.tobytes()
        assert sub.tobytes() == np.ascontiguousarray(want[0][roi]).tobytes()
        assert svc.metrics().per_kind == {"compress": 6, "decompress": 6,
                                          "roi": 1}
    finally:
        svc.stop()


def test_group_cb_dicts_equal_the_reference(mixed):
    fields, ref_blobs = mixed
    got, want = [], []
    engine.compress_many(fields, 1e-2, plan=PLAN, group_cb=got.append,
                         device="cpu")
    ref_engine.compress_many(fields, 1e-2, plan=REF_PLAN,
                             group_cb=want.append)
    engine.decompress_many(ref_blobs, plan=PLAN, group_cb=got.append,
                           device="cpu")
    ref_engine.decompress_many(ref_blobs, plan=REF_PLAN,
                               group_cb=want.append)
    runs = [(ref_blobs[0], [0]), (ref_blobs[2], [0, 1])]
    engine.decode_tiles_many(runs, PLAN, got.append, device="cpu")
    ref_engine.decode_tiles_many(runs, REF_PLAN, want.append)
    assert got == want
    assert {g["kind"] for g in got} == {"compress", "decompress"}
    assert all(g["tile_batches"] for g in got)
    # the chain step reports t and frame_kind in place of tile_batches
    frames = [np.cumsum(np.random.default_rng(t).standard_normal((8, 8, 8)),
                        0) * 0.1 for t in range(3)]
    got, want = [], []
    blobs = temporal.compress_chains([frames, frames[:2]], 1e-2, plan=PLAN,
                                     keyframe_interval=2, group_cb=got.append,
                                     device="cpu")
    rblobs = ref_temporal.compress_chains([frames, frames[:2]], 1e-2,
                                          plan=REF_PLAN, keyframe_interval=2,
                                          group_cb=want.append)
    assert blobs == rblobs and got == want
    assert [g["frame_kind"] for g in got] == ["key", "residual", "key"]


def test_backpressure_rejects_with_retry_after(mixed):
    x = mixed[0][0]
    svc = CompressionService(ServiceConfig(plan=PLAN, max_queue=2,
                                           device="cpu"), autostart=False)
    f1 = svc.submit_compress(x, 1e-2)
    f2 = svc.submit_compress(x, 1e-2)
    with pytest.raises(ServiceOverloaded) as ei:
        svc.submit_compress(x, 1e-2)
    assert ei.value.retry_after > 0
    assert svc.metrics().rejected == 1 and svc.metrics().queue_depth == 2
    svc.stop()  # drains the two queued requests on shutdown
    assert f1.result() == f2.result() == mixed[1][0]


def test_poison_request_fails_alone(mixed):
    good = mixed[0][1]
    bad = np.arange(512, dtype=np.int32).reshape(8, 8, 8)
    svc = CompressionService(CFG, autostart=False)
    try:
        fg = svc.submit_compress(good, 1e-2)
        fb = svc.submit_compress(bad, 1e-2)
        fz = svc.submit_decompress(b"not a container")
        svc.start()
        assert fg.result(timeout=300) == mixed[1][1]
        with pytest.raises(ValueError):
            fb.result(timeout=300)
        with pytest.raises(ValueError):
            fz.result(timeout=300)
        m = svc.metrics()
        assert m.failed == 2 and m.completed == 1
        # the aborted batched attempt does not inflate device groups
        assert m.device_groups == 1
        assert m.mean_device_group_occupancy == 1.0
    finally:
        svc.stop()


def test_stop_without_drain_and_cancelled_futures(mixed):
    x = mixed[0][0]
    svc = CompressionService(CFG, autostart=False)
    futs = [svc.submit_compress(x, 1e-2) for _ in range(3)]
    svc.stop(drain=False)
    assert all(f.cancelled() for f in futs)
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit_compress(x, 1e-2)
    # a client abandoning its queued request drops out of the batch
    svc = CompressionService(CFG, autostart=False)
    try:
        f_cancel = svc.submit_compress(x, 1e-2)
        f_keep = svc.submit_compress(x, 1e-2)
        assert f_cancel.cancel()
        svc.start()
        assert f_keep.result(timeout=300) == mixed[1][0]
        # the worker survived: a fresh request still completes
        assert svc.submit_compress(x, 1e-2).result(timeout=300) == \
            mixed[1][0]
    finally:
        svc.stop()


def test_asyncio_facade(mixed):
    fields, ref_blobs = mixed

    async def go(svc):
        blobs = await asyncio.gather(*[svc.acompress(x, 1e-2)
                                       for x in fields[:3]])
        outs = await asyncio.gather(*[svc.adecompress(b) for b in blobs])
        return blobs, outs

    with CompressionService(CFG) as svc:
        blobs, outs = asyncio.run(go(svc))
    assert list(blobs) == ref_blobs[:3]
    for x, y in zip(fields, outs):
        assert np.abs(x - y).max() <= 1e-2 * (float(x.max()) - float(x.min()))


def test_store_requests_coalesce_and_feed_cache_metrics(tmp_path):
    rng = np.random.default_rng(2)
    store = LopcStore.create(tmp_path / "store", plan=PLAN, device="cpu")
    try:
        fields = {f"a{i}": rng.standard_normal((16, 16, 16)).astype(
            np.float32) for i in range(2)}
        roi = (slice(3, 12), slice(0, 8), slice(0, 8))
        per_roi = len(tiles_for_region(PLAN.layout_for((16, 16, 16)), roi))
        wsvc = CompressionService(CFG, autostart=False)
        try:
            _queue_then_start(wsvc, [(wsvc.submit_store_write, store, n, x,
                                      1e-2) for n, x in fields.items()])
            wm = wsvc.metrics()
            assert wm.max_batch_occupancy == len(fields)
            assert wm.per_kind["store_write"] == len(fields)
        finally:
            wsvc.stop()
        ref = [engine.compress(x, 1e-2, plan=PLAN, device="cpu")
               for x in fields.values()]
        for n, rb in zip(fields, ref):
            assert (store.root / store.info(n)["payload"]).read_bytes() == rb
        svc = CompressionService(CFG, autostart=False)
        try:
            outs = _queue_then_start(
                svc, [(svc.submit_store_roi, store, n, roi)
                      for n in fields for _ in range(2)])
            m = svc.metrics()
            for rb, first, second in zip(ref, outs[::2], outs[1::2]):
                want = engine.decompress(rb, plan=PLAN, device="cpu")[roi]
                assert first.tobytes() == second.tobytes() == \
                    np.ascontiguousarray(want).tobytes()
            assert m.store_reads == 4 and m.cache_hits == 0
            assert m.cache_misses == 2 * per_roi  # once per array
            assert m.decoded_tiles_per_request == pytest.approx(per_roi / 2)
            hot = svc.store_roi(store, "a0", roi)
            m2 = svc.metrics()
            assert hot.tobytes() == outs[0].tobytes()
            assert m2.cache_hits == per_roi
            assert m2.cache_misses == m.cache_misses
            assert "tile cache" in "\n".join(m2.lines())
            # a chain frame read and an unknown name in one batch
            frames = [rng.standard_normal((8, 8, 8)).astype(np.float32)
                      for _ in range(3)]
            store.write_chain("ch", frames, 1e-1, mode="abs",
                              keyframe_interval=2)
            f_frame = svc.submit_store_frame(store, "ch", 2)
            f_bad = svc.submit_store_roi(store, "missing", roi)
            want = temporal.decompress_frame(
                temporal.compress_chain(frames, 1e-1, mode="abs", plan=PLAN,
                                        keyframe_interval=2, device="cpu"),
                2, plan=PLAN, device="cpu")
            assert f_frame.result(timeout=300).tobytes() == want.tobytes()
            with pytest.raises(KeyError, match="missing"):
                f_bad.result(timeout=300)
        finally:
            svc.stop()
    finally:
        store.close()


def test_chain_bytes_survive_bucket_company(mixed):
    rng = np.random.default_rng(3)
    frames = [np.cumsum(rng.standard_normal((8, 8, 8)), 0) * 0.1
              for _ in range(3)]
    mates = mixed[0][:4]
    svc = CompressionService(CFG, autostart=False)
    try:
        results = _queue_then_start(
            svc, [(svc.submit_compress_chain, frames, 1e-2)]
            + [(svc.submit_compress, x, 1e-2) for x in mates])
        assert results[0] == temporal.compress_chain(frames, 1e-2, plan=PLAN,
                                                     device="cpu")
        assert results[1:] == mixed[1][:4]
        assert svc.metrics().max_batch_occupancy == len(mates) + 1
        y = svc.decompress_chain(results[0])
        assert y.tobytes() == temporal.decompress_chain(
            results[0], plan=PLAN, device="cpu").tobytes()
    finally:
        svc.stop()


@pytest.mark.parametrize("knob", ["encode_path", "decode_path"])
def test_paths_are_validated_and_byte_neutral(knob):
    with pytest.raises(ValueError):
        ServiceConfig(plan=PLAN, device="cpu", **{knob: "warp"})
    x = np.random.default_rng(4).standard_normal((16, 16, 16)).astype(
        np.float32)
    blobs, outs = {}, {}
    for path in ("staged", "fused"):
        cfg = ServiceConfig(plan=PLAN, max_delay_ms=5.0, device="cpu",
                            **{knob: path})
        with CompressionService(cfg) as svc:
            blobs[path] = svc.compress(x, 1e-2)
            outs[path] = svc.decompress(blobs[path])
            m = svc.metrics()
            assert m.bytes_h2d > 0 and m.bytes_d2h > 0
            assert "bytes_h2d" not in m.transfers
    assert blobs["staged"] == blobs["fused"]
    assert outs["staged"].tobytes() == outs["fused"].tobytes()


def test_steady_state_adds_zero_library_loads(mixed):
    """The port's counterpart of the reference's zero-retrace check:
    warm traffic through fresh services adds nothing to
    ``device.trace_count()`` (libraries built or loaded)."""
    fields = mixed[0]

    def one_pass():
        svc = CompressionService(CFG, autostart=False)
        blobs = _queue_then_start(svc, [(svc.submit_compress, x, 1e-2)
                                        for x in fields])
        svc.stop()
        svc2 = CompressionService(CFG, autostart=False)
        _queue_then_start(svc2, [(svc2.submit_decompress, b) for b in blobs])
        svc2.stop()
        return blobs, svc.metrics().traces_added + svc2.metrics().traces_added

    one_pass()
    before = device.trace_count()
    blobs, added = one_pass()
    assert added == 0 and device.trace_count() == before
    assert blobs == mixed[1]


def test_config_validation_and_percentile():
    for bad in ({"max_batch_requests": 0}, {"max_delay_ms": -1},
                {"max_queue": 0}, {"adaptive_eb": "nope"},
                {"device": "meta"}):
        with pytest.raises(ValueError):
            ServiceConfig(device=bad.pop("device", "cpu"), **bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServiceConfig()  # the default device is the card
    assert percentile([], 99) == 0.0
    vals = sorted(float(v) for v in range(1, 101))
    assert percentile(vals, 50) == 50.0 and percentile(vals, 99) == 99.0


def _serve(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=timeout)


def test_serve_store_cli_trace_validates(tmp_path):
    trace = tmp_path / "trace.json"
    out = _serve("--store", "--device", "cpu", "--clients", "2",
                 "--requests-per-client", "1", "--chain-frames", "2",
                 "--trace-out", str(trace), "--metrics-dump",
                 str(tmp_path / "metrics.txt"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "tile cache" in out.stdout and "trace" in out.stdout
    doc = json.loads(trace.read_text())
    schema = json.loads((REPO / "benchmarks" / "baselines"
                         / "trace_schema.json").read_text())
    schema["require_names"] = [n for n in schema["require_names"]
                               if not n.startswith(("router.", "lprc.",
                                                    "worker."))]
    schema["nest_under"] = {"exec.": "engine."}
    assert obs.validate_trace(doc, schema) == []
    assert ref_validate_trace(doc, schema) == []
    assert "lopc_service_events_total" in (tmp_path / "metrics.txt").read_text()


def test_serve_cluster_cli_trace_spans_processes(tmp_path):
    """``serve --cluster 2`` on the CPU: two worker subprocesses, every
    region read byte-identical to a single store (also after a worker is
    SIGKILLed), and one trace holding the workers' spans, valid in
    cluster mode from at least 2 processes (what ``benchmarks/
    check_trace.py --mode cluster --min-pids 2`` checks)."""
    trace = tmp_path / "trace.json"
    out = _serve("--cluster", "2", "--device", "cpu", "--clients", "2",
                 "--requests-per-client", "2", "--trace-out", str(trace))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "byte-identical to a single-process store" in out.stdout
    assert "DOWN: [" in out.stdout and "served by replicas" in out.stdout
    doc = json.loads(trace.read_text())
    schema = json.loads((REPO / "benchmarks" / "baselines"
                         / "trace_schema.json").read_text())
    assert obs.validate_trace(doc, schema) == []
    assert ref_validate_trace(doc, schema) == []
    assert len({s["pid"] for s in doc["spans"]}) >= 2
    assert {s["name"] for s in doc["spans"]} >= {
        "router.write", "router.gather", "lprc.call", "worker.READ_TILES",
        "worker.PUT_SHARD", "exec.decode"}


def test_serve_cli_refuses_cleanly():
    bad = _serve("--store", "--device", "cpu", "--tile", "8,8", timeout=120)
    assert bad.returncode != 0 and "Traceback" not in bad.stderr
    assert "--tile wants three positive ints" in bad.stderr
    out = _serve("--arch", "x", timeout=120)
    assert out.returncode != 0 and "Traceback" not in out.stderr
    assert "invalid choice: 'x'" in out.stderr
