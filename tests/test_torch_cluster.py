"""The port's sharded store cluster (``repro_torch.cluster``) against the
JAX reference's (``repro.cluster``) on the CPU.

The rig is ``tests/test_cluster.py``'s: (8, 8, 8) tiles, batch 4, 4
shards, 2 replicas, no backoff, a 24x20x16 float32 field with one NaN
(the non-finite sidecar rides every shard's sparse container).  Each of
that file's contracts is held here against the reference: placement
equal to ``repro.cluster.ShardMap``'s; the same writes through both
packages' clusters leave byte-equal payload files on every shard and
give byte-equal region, full and chain-frame reads, equal to a single
``LopcStore``'s, also through a killed worker; the committed store
fixture served byte for byte; writes need every owner, reads one live
replica; poison isolation; LPRC frames equal to the reference's.  LPRC
is normative, so the two packages also talk to each other: the
reference's ``SocketTransport`` against a port worker's socket, and the
reference's ``Router`` over port workers.  The two cluster trace tests
of ``tests/test_obs.py`` validate in cluster mode under both packages'
``validate_trace``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.cluster import LocalCluster as RefCluster
from repro.cluster import LocalTransport as RefLocalTransport
from repro.cluster import RemoteError as RefRemoteError
from repro.cluster import Router as RefRouter
from repro.cluster import ShardMap as RefShardMap
from repro.cluster import SocketTransport as RefSocketTransport
from repro.cluster import metrics as ref_cluster_metrics
from repro.cluster import protocol as ref_proto
from repro.engine.plan import CompressionPlan as RefPlan
from repro_torch import engine, obs
from repro_torch.cluster import (
    ClusterUnavailable,
    LocalCluster,
    RemoteError,
    Router,
    ShardDown,
    ShardMap,
    ShardWorker,
    SocketTransport,
)
from repro_torch.cluster import metrics as cluster_metrics
from repro_torch.cluster import protocol as proto
from repro_torch.core import bitstream
from repro_torch.engine.plan import CompressionPlan
from repro_torch.store import LopcStore

DATA = Path(__file__).resolve().parent / "data"
PLAN = CompressionPlan(tile_shape=(8, 8, 8), batch_tiles=4)
REF_PLAN = RefPlan(tile_shape=(8, 8, 8), batch_tiles=4)
EB = 1e-2
ROIS = [
    (slice(0, 24), slice(0, 20), slice(0, 16)),
    (slice(3, 14), slice(2, 10), slice(5, 13)),
    (slice(7, 8), slice(0, 20), slice(15, 16)),
]
SCHEMA = json.loads(
    (Path(__file__).parent.parent / "benchmarks" / "baselines"
     / "trace_schema.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(root, n_shards=4, **kw):
    return LocalCluster(root, n_shards, plan=kw.pop("plan", PLAN),
                        n_replicas=2, backoff=0.0, device="cpu", **kw)


def _ref(root, n_shards=4, **kw):
    return RefCluster(root, n_shards, plan=kw.pop("plan", REF_PLAN),
                      n_replicas=2, backoff=0.0, **kw)


@pytest.fixture
def clusters(tmp_path):
    """The port's cluster and the reference's, built alike."""
    with _port(tmp_path / "port") as cl, _ref(tmp_path / "ref") as rcl:
        yield cl, rcl


def _field(seed=0, shape=(24, 20, 16)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[1, 2, 3] = np.nan  # the non-finite sidecar, replicated to every owner
    return x


def _payload(store, name) -> bytes:
    return (store.root / store.info(name)["payload"]).read_bytes()


def _shard_payloads(cluster, name) -> dict[int, bytes]:
    return {i: _payload(w.store, name) for i, w in enumerate(cluster.workers)
            if name in w.store.names()}


# ------------------------------------------------------------- placement

def test_shard_map_equals_the_reference():
    for geom in ((4, 2), (5, 3), (1, 1), (7, 2)):
        a, r = ShardMap(*geom), RefShardMap(*geom)
        assert a == ShardMap(*geom)
        for name in ("x", "some-array", "field0", "évolution", "c2"):
            assert a.home(name) == r.home(name)
            for tid in range(0, 300, 7):
                owners = a.owners(name, tid)
                assert owners == r.owners(name, tid)
                assert len(set(owners)) == geom[1]
            for s in range(geom[0]):
                assert a.shard_tiles(name, 90, s) == r.shard_tiles(name, 90, s)
            assert a.split(name, range(40)) == r.split(name, range(40))
    custom = ShardMap(6, 2, vnodes=5, tiles_per_range=3)
    ref_custom = RefShardMap(6, 2, vnodes=5, tiles_per_range=3)
    assert [custom.owners("y", t) for t in range(50)] == \
        [ref_custom.owners("y", t) for t in range(50)]


def test_shard_map_validates_geometry():
    for kw, what in (({"n_shards": 2, "n_replicas": 3}, "n_replicas"),
                     ({"n_shards": 0}, "n_shards"),
                     ({"n_shards": 2, "vnodes": 0}, "vnodes"),
                     ({"n_shards": 2, "tiles_per_range": 0},
                      "tiles_per_range")):
        with pytest.raises(ValueError, match=what):
            ShardMap(**kw)


# ---------------------------------------------------------- byte identity

def test_cluster_writes_the_references_shard_payloads(clusters, tmp_path):
    """The same write through both clusters: every shard's payload file
    equal, every read equal to the reference's and to a single store."""
    cl, rcl = clusters
    x = _field()
    cl.router.write("x", x, EB)
    rcl.router.write("x", x, EB)
    got = _shard_payloads(cl, "x")
    assert got == _shard_payloads(rcl, "x") and len(got) >= 2
    single = LopcStore.create(tmp_path / "single", plan=PLAN, device="cpu")
    try:
        single.write("x", x, EB)
        for roi in ROIS:
            a = cl.router.read_roi("x", roi)
            assert a.tobytes() == rcl.router.read_roi("x", roi).tobytes()
            assert a.tobytes() == single.read_roi("x", roi).tobytes()
        full = cl.router.read("x")
        assert full.tobytes() == rcl.router.read("x").tobytes()
        assert full.tobytes() == single.read("x").tobytes()
        assert cl.router.metrics.snapshot() == rcl.router.metrics.snapshot()
        # put of the single store's container scatters the same sections
        for c in (cl, rcl):
            c.router.put("y", _payload(single, "x"))
        assert _shard_payloads(cl, "y") == _shard_payloads(rcl, "y")
        assert cl.router.read("y").tobytes() == full.tobytes()
    finally:
        single.close()
    assert sorted(cl.router.names()) == ["x", "y"]
    assert cl.router.info("x") == rcl.router.info("x")


def test_cluster_serves_committed_store_fixture(tmp_path):
    """The committed store fixture, lifted verbatim into a 4-shard port
    cluster, reads back byte-identical to the single store (snapshots by
    region, chains by frame) and to ``expected.npz``."""
    fixture = LopcStore.open(DATA / "store", device="cpu")
    want = np.load(DATA / "expected.npz")
    try:
        with _port(tmp_path / "cluster", plan=fixture.plan) as cl:
            snap_info = fixture.info("snap")
            cl.router.put("snap", _payload(fixture, "snap"))
            chain_info = fixture.info("evolution")
            cl.router.put_chain("evolution", chain_info,
                                _payload(fixture, "evolution"))
            shape = tuple(snap_info["shape"])
            for roi in (tuple(slice(0, n) for n in shape),
                        tuple(slice(1, n - 1) for n in shape)):
                assert fixture.read_roi("snap", roi).tobytes() == \
                    cl.router.read_roi("snap", roi).tobytes()
            assert cl.router.read("snap").tobytes() == \
                want["store_snap"].tobytes()
            for t in range(fixture.n_frames("evolution")):
                assert fixture.read_frame("evolution", t).tobytes() == \
                    cl.router.read_frame("evolution", t).tobytes()
            assert cl.router.read("evolution").tobytes() == \
                want["store_chain"].tobytes()
            assert cl.router.n_frames("evolution") == 3
            assert cl.router.info("snap")["crc32"] != 0
            assert sorted(cl.router.names()) == ["evolution", "snap"]
            # the home replicas hold the chain's payload byte for byte
            for s in cl.router.map.home("evolution"):
                assert _payload(cl.workers[s].store, "evolution") == \
                    _payload(fixture, "evolution")
    finally:
        fixture.close()


def test_chain_append_keeps_replicas_bit_identical(clusters, tmp_path):
    cl, rcl = clusters
    rng = np.random.default_rng(3)
    frames = [rng.standard_normal((10, 9, 8)).astype(np.float32)
              for _ in range(3)]
    single = LopcStore.create(tmp_path / "single", plan=PLAN, device="cpu")
    try:
        single.write_chain("c", frames[:2], 1e-1, mode="abs",
                           keyframe_interval=2)
        single.append_frame("c", frames[2])
        for c in (cl, rcl):
            n = c.router.write_chain("c", frames[:2], 1e-1, mode="abs",
                                     keyframe_interval=2)
            assert n > 0
            assert c.router.append_frame("c", frames[2]) == 2
        for t in range(3):
            a = cl.router.read_frame("c", t)
            assert a.tobytes() == single.read_frame("c", t).tobytes()
            assert a.tobytes() == rcl.router.read_frame("c", t).tobytes()
        # every home replica re-encoded the append to the single store's
        # bytes, and the reference's replicas hold the same
        want = _payload(single, "c")
        homes = cl.router.map.home("c")
        assert len(homes) == 2
        assert _shard_payloads(cl, "c") == {s: want for s in homes}
        assert _shard_payloads(rcl, "c") == {s: want for s in homes}
        assert cl.router.read("c").tobytes() == single.read("c").tobytes()
    finally:
        single.close()


# --------------------------------------------------------------- failover

def test_killed_worker_fails_over_with_identical_bytes(clusters, tmp_path):
    cl, rcl = clusters
    x = _field(1)
    single = LopcStore.create(tmp_path / "single", plan=PLAN, device="cpu")
    try:
        single.write("x", x, EB)
        for c in (cl, rcl):
            c.router.write("x", x, EB)
            c.kill(c.router.map.owners("x", 0)[0])
        victim = cl.router.map.owners("x", 0)[0]
        for roi in ROIS:
            a = cl.router.read_roi("x", roi)
            assert a.tobytes() == single.read_roi("x", roi).tobytes()
            assert a.tobytes() == rcl.router.read_roi("x", roi).tobytes()
        m, rm = cl.router.cluster_metrics(), rcl.router.cluster_metrics()
        assert m["failover_reads"] > 0
        assert m["shards"][victim]["up"] is False
        assert m["shards"][victim]["failures"] > 0
        assert m["workers"]["workers_reporting"] == 3
        # the router's counters and health are the reference's
        assert {k: v for k, v in m.items() if k != "workers"} == \
            {k: v for k, v in rm.items() if k != "workers"}
        assert m["workers"].keys() == rm["workers"].keys()
        for k in ("submitted", "completed", "failed", "store_reads",
                  "cache_hits", "cache_misses", "workers_reporting"):
            assert m["workers"][k] == rm["workers"][k], k
        # revive: the shard serves again and health recovers
        cl.revive(victim)
        cl.router.read_roi("x", ROIS[1])
        assert cl.router.cluster_metrics()["shards"][victim]["up"]
    finally:
        single.close()


def test_chain_reads_fail_over_but_writes_require_all_owners(clusters):
    cl, _ = clusters
    rng = np.random.default_rng(4)
    frames = [rng.standard_normal((8, 8, 8)).astype(np.float32)
              for _ in range(2)]
    cl.router.write_chain("c", frames, 1e-1, mode="abs", keyframe_interval=2)
    primary = cl.router.map.home("c")[0]
    before = cl.router.read_frame("c", 1)
    cl.kill(primary)
    after = cl.router.read_frame("c", 1)
    assert before.tobytes() == after.tobytes()
    assert cl.router.metrics.snapshot()["failover_reads"] == 1
    with pytest.raises(ShardDown):
        cl.router.append_frame("c", frames[0])
    with pytest.raises(ShardDown):
        cl.router.write_chain("c2", frames, 1e-1, mode="abs")
    with pytest.raises(ShardDown):
        cl.router.write("x", _field(), EB)  # some range is owned by it
    with pytest.raises(ShardDown):
        cl.router.delete("c")


def test_all_replicas_down_raises_cluster_unavailable(clusters):
    cl, _ = clusters
    cl.router.write("x", _field(), EB)
    for s in range(4):
        cl.kill(s)
    with pytest.raises(ClusterUnavailable):
        cl.router.read_roi("x", ROIS[1])
    with pytest.raises(ClusterUnavailable):
        cl.router.info("x")
    assert cl.router.names() == []
    assert cl.router.cluster_metrics()["workers"]["workers_reporting"] == 0


# -------------------------------------------------------- poison isolation

def test_router_poison_isolation(clusters):
    """A bad request fails alone, with the reference's exception types:
    the shard that answered it stays healthy and keeps serving."""
    cl, rcl = clusters
    x = _field(2)
    for c in (cl, rcl):
        c.router.write("x", x, EB)
    good = cl.router.read_roi("x", ROIS[1])
    for c in (cl, rcl):
        with pytest.raises(KeyError):
            c.router.info("missing-array")
        with pytest.raises(ValueError):
            c.router.read_roi("x", (slice(0, 24, 2),) * 3)  # stepped slice
        with pytest.raises(ValueError, match="read_frame"):
            c.router.read_frame("x", 0)
    m = cl.router.cluster_metrics()
    assert all(h["up"] for h in m["shards"])
    assert cl.router.read_roi("x", ROIS[1]).tobytes() == good.tobytes()
    cl.router.delete("x")
    assert cl.router.names() == []


def test_router_refuses_a_mesh_and_defaults_to_the_card(tmp_path):
    with pytest.raises(NotImplementedError, match="row 13"):
        Router([object()], mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Router([object(), object()])
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardWorker(tmp_path / "w")
        with pytest.raises(RuntimeError, match="CUDA"):
            LocalCluster(tmp_path / "cl", 2)


# ----------------------------------------------------------- wire protocol

def test_protocol_frames_equal_the_references():
    payload = bytes(range(256))
    for op, seq, header, body in (
            (proto.OP_READ_TILES, 7, {"name": "x", "tile_ids": [1, 2]},
             payload),
            (proto.OP_PING, 0, {}, b""),
            (proto.OP_ERROR, 2**32 - 1, {"error": "KeyError",
                                         "message": "é"}, b""),
            (proto.OP_APPEND_FRAME, 3, {"shape": [2, 3], "dtype": "float32",
                                        "name": "c"}, b"\0" * 24)):
        frame = proto.encode_frame(op, seq, header, body)
        assert frame == ref_proto.encode_frame(op, seq, header, body)
        assert proto.decode_frame(frame + b"extra") == \
            ref_proto.decode_frame(frame + b"extra")
    assert proto.PRELUDE_SIZE == ref_proto.PRELUDE_SIZE
    assert {k: getattr(proto, k) for k in dir(ref_proto) if k.startswith("OP_")} \
        == {k: getattr(ref_proto, k) for k in dir(ref_proto)
            if k.startswith("OP_")}
    assert proto.op_name(proto.OP_READ_TILES) == "READ_TILES"
    frame = proto.encode_frame(proto.OP_INFO, 1, {"name": "x"}, payload)
    for cut in (0, 3, proto.PRELUDE_SIZE, len(frame) - 1):
        with pytest.raises(proto.NeedMore):
            proto.decode_frame(frame[:cut])
    with pytest.raises(ValueError, match="magic"):
        proto.decode_frame(b"XXXX" + frame[4:])
    with pytest.raises(ValueError, match="version"):
        proto.decode_frame(frame[:4] + b"\x02" + frame[5:])

    # a tile cut out of a decoded batch is a strided view: it crosses as
    # the C-order bytes of its values, as the reference packs a copy
    batch = torch.arange(2 * 6 * 5, dtype=torch.float32).reshape(2, 6, 5)
    view = batch[:, 1:5, ::2].cpu().numpy()
    assert not view.flags.c_contiguous
    arrays = [view, np.arange(6, dtype=np.float64).reshape(2, 3),
              np.array(3.5, dtype=np.float64)]
    metas, blob = proto.pack_arrays(arrays)
    assert (metas, blob) == ref_proto.pack_arrays(arrays)
    back = proto.unpack_arrays(metas, blob)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and np.ascontiguousarray(a).tobytes() == \
            b.tobytes()
    with pytest.raises(ValueError):
        proto.unpack_arrays(metas, blob + b"\0")
    with pytest.raises(ValueError):
        proto.unpack_arrays(metas, blob[:-1])


def test_reference_socket_transport_talks_to_a_port_worker(tmp_path):
    """LPRC both ways: the reference's ``SocketTransport`` against a port
    ``ShardWorker.serve()`` (PING, PUT_SHARD, READ_TILES, INFO, METRICS,
    an OP_ERROR as ``RemoteError``), then the port's own transport, and
    a stopped server as ``ShardDown``."""
    x = np.random.default_rng(5).standard_normal((16, 8, 8)).astype(
        np.float32)
    blob = engine.compress(x, EB, plan=PLAN, device="cpu")
    worker = ShardWorker(tmp_path / "shard", plan=PLAN, device="cpu")
    port, stop_serving = worker.serve()
    ref_t = RefSocketTransport("127.0.0.1", port, timeout=30.0)
    our_t = SocketTransport("127.0.0.1", port, timeout=30.0)
    try:
        for t in (ref_t, our_t):
            h, _ = t.call(proto.OP_PING, {})
            assert h["ok"] is True
        ref_t.call(proto.OP_PUT_SHARD, {"name": "x"}, blob)
        want = engine.decompress(blob, plan=PLAN, device="cpu")
        for t in (ref_t, our_t):
            h, p = t.call(proto.OP_READ_TILES,
                          {"name": "x", "tile_ids": [1, 0]})
            tiles = proto.unpack_arrays(h["tiles"], p)
            assert [m["id"] for m in h["tiles"]] == [1, 0]
            assert tiles[1].tobytes() == \
                np.ascontiguousarray(want[:8, :8, :8]).tobytes()
            assert tiles[0].tobytes() == \
                np.ascontiguousarray(want[8:, :8, :8]).tobytes()
            h, _ = t.call(proto.OP_INFO, {"name": "x"})
            assert tuple(h["info"]["shape"]) == x.shape
            h, _ = t.call(proto.OP_METRICS, {})
            assert json.dumps(h["service"])  # wire-serializable metrics
        with pytest.raises(RefRemoteError, match="KeyError"):
            ref_t.call(proto.OP_INFO, {"name": "missing"})
        with pytest.raises(RemoteError, match="KeyError"):
            our_t.call(proto.OP_INFO, {"name": "missing"})
        with pytest.raises(RefRemoteError, match="ValueError"):
            ref_t.call(99, {})  # unknown op: the connection survives
        assert ref_t.call(proto.OP_PING, {})[0]["ok"] is True
        h, _ = ref_t.call(proto.OP_NAMES, {})
        assert h["names"] == ["x"]
    finally:
        stop_serving()
        ref_t.close()
        our_t.close()
        worker.close()
    with pytest.raises(ShardDown):
        SocketTransport("127.0.0.1", port, timeout=0.5).call(
            proto.OP_PING, {})


def test_reference_router_over_port_workers(tmp_path):
    """The reference's ``Router`` over ``LocalTransport``s to port
    workers reads what the reference's own cluster reads, also through a
    killed worker; the port's workers store the reference's shards."""
    x = _field(6)
    workers = [ShardWorker(tmp_path / f"p{i}", plan=PLAN, device="cpu")
               for i in range(4)]
    try:
        transports = [RefLocalTransport(w) for w in workers]
        router = RefRouter(transports, plan=REF_PLAN, n_replicas=2,
                           backoff=0.0)
        with _ref(tmp_path / "ref") as rcl:
            router.write("x", x, EB)
            rcl.router.write("x", x, EB)
            got = {i: _payload(w.store, "x") for i, w in enumerate(workers)
                   if "x" in w.store.names()}
            assert got == _shard_payloads(rcl, "x")
            for roi in ROIS:
                assert router.read_roi("x", roi).tobytes() == \
                    rcl.router.read_roi("x", roi).tobytes()
            transports[router.map.owners("x", 0)[0]].kill()
            assert router.read("x").tobytes() == rcl.router.read("x").tobytes()
            assert router.metrics.snapshot()["failover_reads"] > 0
    finally:
        for w in workers:
            w.close()


def test_sparse_shard_containers_parse_and_stream_words(clusters):
    """A shard's sparse container is a valid v2 container whose
    non-owned entries are empty; ``stream_words`` answers from the first
    present tile; every tile sits on exactly 2 shards, as sections cut
    byte-verbatim out of the whole container."""
    cl, _ = clusters
    x = _field()
    blob = engine.compress(x, EB, plan=PLAN, device="cpu")
    cl.router.write("x", x, EB)
    whole = bitstream.read_container_v2(blob)
    seen = 0
    for s, w in enumerate(cl.workers):
        if "x" not in w.store.names():
            continue
        c = bitstream.read_container_v2(_payload(w.store, "x"))
        assert c.n_tiles == whole.n_tiles
        present = [i for i, e in enumerate(c.entries) if e.bins_len > 0]
        assert present == cl.router.map.shard_tiles("x", c.n_tiles, s)
        for t in present:
            assert c.tile_payloads(t) == whole.tile_payloads(t)
        seen += len(present)
        assert c.stream_words() == whole.stream_words()
        assert c.extra_section(bitstream.TAG_NONFINITE) == \
            whole.extra_section(bitstream.TAG_NONFINITE)
    assert seen == 2 * whole.n_tiles


# ---------------------------------------------------------------- metrics

def test_sum_fields_equal_the_references_and_guard_drift(monkeypatch):
    assert cluster_metrics._SUM_FIELDS == ref_cluster_metrics._SUM_FIELDS
    assert cluster_metrics._NON_SUMMABLE == ref_cluster_metrics._NON_SUMMABLE
    monkeypatch.setattr(cluster_metrics, "_NON_SUMMABLE",
                        cluster_metrics._NON_SUMMABLE | {"no_such_field"})
    with pytest.raises(TypeError, match="no_such_field"):
        cluster_metrics._summable_fields()
    monkeypatch.setattr(cluster_metrics, "_NON_SUMMABLE",
                        cluster_metrics._NON_SUMMABLE - {"no_such_field",
                                                         "mbps"})
    with pytest.raises(TypeError, match="mbps"):
        cluster_metrics._summable_fields()
    snaps = [{"cache_hits": 3, "cache_misses": 1, "completed": 2}, None,
             {"cache_hits": 1, "cache_misses": 3, "bytes_h2d": 10}]
    assert cluster_metrics.ClusterMetrics.aggregate(snaps) == \
        ref_cluster_metrics.ClusterMetrics.aggregate(snaps)
    m, rm = cluster_metrics.ClusterMetrics(3), \
        ref_cluster_metrics.ClusterMetrics(3)
    for c in (m, rm):
        c.record_write(2_000_000)
        c.record_read(5)
        c.record_failover(2)
        c.record_shard_failure(1, ShardDown("gone"))
    agg = cluster_metrics.ClusterMetrics.aggregate(snaps)
    assert m.snapshot() == rm.snapshot()
    assert m.lines(agg) == rm.lines(agg)


# ---------------------------------------------------------------- tracing

def _traced(package):
    package.tracer().drain()
    package.FLIGHT.clear()
    package.enable()


def _untraced(package):
    package.disable()
    package.FLIGHT.clear()


def _pairs(spans) -> set:
    by_id = {s.span_id: s.name for s in spans}
    return {(s.name, by_id.get(s.parent_id)) for s in spans}


def _one_request(pkg, cluster, x):
    with pkg.span("client.request"):
        cluster.router.write("f", x, 1e-2)
        return cluster.router.read_roi(
            "f", (slice(0, 16), slice(0, 16), slice(0, 8)))


def test_cluster_request_yields_one_trace_tree(tmp_path):
    """One logical request against a 4-shard port cluster: a single
    trace spanning router scatter -> LPRC -> worker service -> engine
    device group -> executor stages, valid in cluster mode under both
    packages' validators, with the reference's (name, parent) pairs."""
    x = np.random.default_rng(7).standard_normal((24, 20, 16)).astype(
        np.float32)
    _traced(obs)
    try:
        with _port(tmp_path / "cl") as cl:
            roi = _one_request(obs, cl, x)
            spans = obs.tracer().drain()
    finally:
        _untraced(obs)
    _traced(ref_obs)
    try:
        with _ref(tmp_path / "ref") as rcl:
            ref_roi = _one_request(ref_obs, rcl, x)
            ref_spans = ref_obs.tracer().drain()
    finally:
        _untraced(ref_obs)

    assert roi.tobytes() == ref_roi.tobytes()
    assert len({s.trace_id for s in spans}) == 1  # one request, one tree
    doc = obs.write_trace(str(tmp_path / "trace.json"), spans,
                          meta={"mode": "cluster"})
    assert obs.validate_trace(doc, SCHEMA) == []
    on_disk = json.loads((tmp_path / "trace.json").read_text())
    assert ref_obs.validate_trace(on_disk, SCHEMA) == []
    assert _pairs(spans) == _pairs(ref_spans)
    names = {s.name for s in spans}
    for must in ("router.write", "router.scatter", "router.read",
                 "router.gather", "lprc.call", "worker.PUT_SHARD",
                 "worker.READ_TILES", "service.request", "service.group",
                 "store.read", "engine.compress_group",
                 "engine.decode_group", "exec.upload", "exec.solve",
                 "exec.encode", "exec.download", "exec.decode"):
        assert must in names, must
    by_id = {s.span_id: s for s in spans}
    node = next(s for s in spans if s.name == "exec.decode")
    lineage = []
    while node.parent_id is not None:
        node = by_id[node.parent_id]
        lineage.append(node.name)
    assert lineage[-1] == "client.request"
    assert "worker.READ_TILES" in lineage and "lprc.call" in lineage
    assert len(doc["traceEvents"]) == len(spans)
    assert all(e["ph"] == "X" and e["dur"] >= 1 for e in doc["traceEvents"])


def test_failover_trace_contains_failed_attempt_and_dump(tmp_path):
    x = np.random.default_rng(8).standard_normal((24, 20, 16)).astype(
        np.float32)
    _traced(obs)
    try:
        with _port(tmp_path / "cl") as cl:
            cl.router.write("f", x, 1e-2)
            obs.tracer().drain()  # keep only the degraded read's trace
            victim = cl.router.map.owners("f", 0)[0]
            cl.kill(victim)
            roi = cl.router.read_roi(
                "f", (slice(0, 16), slice(0, 16), slice(0, 8)))
            assert roi.shape == (16, 16, 8)
            spans = obs.tracer().drain()
        dumps = obs.FLIGHT.dumps("shard_down")
    finally:
        _untraced(obs)

    (tid,) = {s.trace_id for s in spans}
    downs = [s for s in spans if s.name == "lprc.call"
             and s.status == "ShardDown"]
    assert downs and all(s.tags["shard"] == victim for s in downs)
    gather = next(s for s in spans if s.name == "router.gather")
    assert gather.tags["rounds"] == 2  # the replica retry round ran
    assert gather.tags["failover_tiles"] >= 1
    assert dumps, "ShardDown must leave a flight dump"
    d = dumps[0]
    assert d["trace_id"] == tid and d["context"]["shard"] == victim
    assert any(e["status"] == "ShardDown" for e in d["recent_events"])
    # the read's trace alone: no write spans, so the cluster-mode names
    # of a write are not required of it
    schema = dict(SCHEMA, require_names=[
        n for n in SCHEMA["require_names"]
        if not n.startswith(("router.write", "router.scatter", "exec.upload",
                             "exec.solve", "exec.encode", "exec.download"))])
    doc = obs.write_trace(str(tmp_path / "failover.json"), spans)
    assert obs.validate_trace(doc, schema) == []
    assert ref_obs.validate_trace(
        json.loads((tmp_path / "failover.json").read_text()), schema) == []


def test_socket_worker_spans_ride_home(tmp_path):
    """A traced router over a socket worker: the worker's spans come back
    on the LPRC reply and parent under the router's ``lprc.call``."""
    x = np.random.default_rng(9).standard_normal((16, 8, 8)).astype(
        np.float32)
    worker = ShardWorker(tmp_path / "shard", plan=PLAN, device="cpu")
    port, stop_serving = worker.serve()
    _traced(obs)
    try:
        router = Router([SocketTransport("127.0.0.1", port, timeout=30.0)],
                        plan=PLAN, n_replicas=1, backoff=0.0, device="cpu")
        with obs.span("client.request"):
            router.write("x", x, EB)
            got = router.read("x")
        spans = obs.tracer().drain()
        router.transports[0].close()
    finally:
        _untraced(obs)
        stop_serving()
        worker.close()
    assert got.tobytes() == engine.decompress(
        engine.compress(x, EB, plan=PLAN, device="cpu"), plan=PLAN,
        device="cpu").tobytes()
    by_id = {s.span_id: s for s in spans}
    reads = [s for s in spans if s.name == "worker.READ_TILES"]
    assert reads and all(by_id[s.parent_id].name == "lprc.call"
                         for s in reads)
    assert len({s.trace_id for s in spans}) == 1
    doc = obs.write_trace(str(tmp_path / "socket.json"), spans)
    assert obs.validate_trace(doc, SCHEMA) == []

