"""The port's store (``repro_torch.store``) against the JAX reference on
the CPU.

The committed store fixture (``tests/data/store/``, written by the
reference's ``LopcStore`` through ``tests/data/make_fixtures.py``) is
replayed through the port: the manifest and both payload files must
equal the committed bytes, and the reads ``expected.npz``'s values bit
for bit; the committed store also opens and reads in the port.  The
other cases follow ``tests/test_store.py`` against a live reference
store driven with the same calls: equal manifests and payloads, reads
equal to the reference's decode, region reads that decode only their
tiles and read only part of the payload file, deduplicated batched
reads with the reference's ``group_cb`` dicts, overwrite and crash
recovery, appended frames equal to a whole-chain compress, and the
reference's errors.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import engine as ref_engine
from repro import temporal as ref_temporal
from repro.engine.plan import CompressionPlan as RefPlan
from repro.store import LopcStore as RefStore
from repro_torch import engine, temporal
from repro_torch.core import bitstream
from repro_torch.data.fields import make_field_sequence, make_scientific_field
from repro_torch.engine.executor import DECODE_COUNTS
from repro_torch.engine.plan import CompressionPlan, tiles_for_region
from repro_torch.store import LopcStore, TileCache

DATA = Path(__file__).resolve().parent / "data"
PLAN = CompressionPlan(tile_shape=(8, 8, 8), batch_tiles=4)
FIXTURE_PLAN = CompressionPlan(tile_shape=(8, 8, 8))  # make_fixtures.py's
REF_PLAN = RefPlan(tile_shape=(8, 8, 8), batch_tiles=4)
EB = 1e-2
ROI = (slice(3, 14), slice(2, 10), slice(5, 13))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stores(tmp_path):
    """The port's store and the reference's, created alike."""
    s = LopcStore.create(tmp_path / "port", plan=PLAN, device="cpu")
    r = RefStore.create(tmp_path / "ref", plan=REF_PLAN)
    yield s, r
    s.close()
    r.close()


def _field(seed, shape=(24, 20, 16), dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _payload(store, name) -> bytes:
    return (store.root / store.info(name)["payload"]).read_bytes()


def _manifest(store) -> bytes:
    return (store.root / "manifest.json").read_bytes()


# ------------------------------------------------------ committed fixture

def test_fixture_replay_writes_the_committed_bytes(tmp_path):
    """``tests/data/make_fixtures.py``'s store calls through the port."""
    store = LopcStore.create(tmp_path / "store", plan=FIXTURE_PLAN,
                             device="cpu")
    s = make_scientific_field("front", (12, 11, 10), np.float32, seed=24)
    store.write("snap", s, EB)
    sframes = make_field_sequence("diffuse", "waves", (10, 9, 8), 3,
                                  np.float32, seed=25)
    store.write_chain("evolution", sframes[:2], 1e-1, mode="abs",
                      keyframe_interval=2)
    store.append_frame("evolution", sframes[2])
    snap = store.read("snap")
    chain = store.read("evolution")
    store.close()
    for rel in ("manifest.json", "payload/snap.lopc",
                "payload/evolution.frames"):
        assert (tmp_path / "store" / rel).read_bytes() == \
            (DATA / "store" / rel).read_bytes(), rel
    want = np.load(DATA / "expected.npz")
    for got, key in ((snap, "store_snap"), (chain, "store_chain")):
        assert got.dtype == want[key].dtype and got.shape == want[key].shape
        assert got.tobytes() == want[key].tobytes(), key


def test_opening_the_committed_fixture_reads_its_values(tmp_path):
    shutil.copytree(DATA / "store", tmp_path / "store")
    want = np.load(DATA / "expected.npz")
    store = LopcStore.open(tmp_path / "store", device="cpu")
    try:
        assert store.names() == ["evolution", "snap"]
        assert store.plan == FIXTURE_PLAN
        assert store.read("snap").tobytes() == want["store_snap"].tobytes()
        assert store.read("evolution").tobytes() == \
            want["store_chain"].tobytes()
        for t in range(store.n_frames("evolution")):
            assert store.read_frame("evolution", t).tobytes() == \
                want["store_chain"][t].tobytes()
        box = (slice(2, 11), slice(0, 9), slice(3, 10))
        assert store.read_roi("snap", box).tobytes() == \
            np.ascontiguousarray(want["store_snap"][box]).tobytes()
    finally:
        store.close()
    # the device is an open-time choice: nothing was written
    for rel in ("manifest.json", "payload/snap.lopc",
                "payload/evolution.frames"):
        assert (tmp_path / "store" / rel).read_bytes() == \
            (DATA / "store" / rel).read_bytes(), rel


# ------------------------------------------------------ against the reference

def test_read_roi_decodes_only_overlapping_tiles(stores):
    s, r = stores
    x = _field(1)
    s.write("x", x, EB)
    r.write("x", x, EB)
    assert _payload(s, "x") == _payload(r, "x")
    assert _manifest(s) == _manifest(r)
    want = r.read_roi("x", ROI)
    layout = PLAN.layout_for(x.shape)
    expected_tiles = len(tiles_for_region(layout, ROI))
    assert 0 < expected_tiles < layout.n_tiles

    d0 = DECODE_COUNTS["tiles"]
    cold = s.read_roi("x", ROI)
    assert DECODE_COUNTS["tiles"] - d0 == expected_tiles
    assert cold.tobytes() == want.tobytes()
    # cached re-read: zero decodes, identical bytes
    d0 = DECODE_COUNTS["tiles"]
    cached = s.read_roi("x", ROI)
    assert DECODE_COUNTS["tiles"] - d0 == 0
    assert cached.tobytes() == cold.tobytes()
    # outputs are fresh arrays: mutating one cannot poison the cache
    cold[...] = 0
    assert s.read_roi("x", ROI).tobytes() == want.tobytes()


def test_read_roi_fetches_partial_bytes_from_disk(stores):
    s, _ = stores
    x = _field(2, (32, 32, 32))
    s.write("x", x, EB)
    nbytes = s.info("x")["nbytes"]
    small = (slice(0, 8), slice(0, 8), slice(0, 8))  # one tile of 64
    out = s.read_roi("x", small)
    source = s._readers["x"][2]
    assert source.bytes_read < nbytes // 2, \
        "a one-tile read should not fetch most of the payload file"
    full = engine.decompress(_payload(s, "x"), plan=PLAN, device="cpu")
    assert out.tobytes() == np.ascontiguousarray(full[small]).tobytes()


def test_read_roi_many_batches_and_dedups(stores):
    """Misses of one hot tile decode once, arrays with one signature share
    a decode group, and the stats and group dicts are the reference's."""
    s, r = stores
    xs = {f"a{i}": _field(10 + i) for i in range(3)}
    s.write_many(list(xs), list(xs.values()), EB)
    for n in xs:  # the port's containers are the reference's (see above)
        r.put(n, _payload(s, n))
    assert _manifest(s) == _manifest(r)
    items = [(n, ROI) for n in xs] + [(n, ROI) for n in xs]
    got, want = {}, {}
    for store, out in ((s, got), (r, want)):
        infos, groups = [], []
        outs = store.read_roi_many(items, stats_cb=infos.append,
                                   group_cb=groups.append)
        out.update(outs=outs, infos=infos, groups=groups)
    for a, b in zip(got["outs"], want["outs"]):
        assert a.tobytes() == b.tobytes()
    assert got["infos"] == want["infos"]
    assert got["groups"] == want["groups"]
    (info,) = got["infos"]
    per_roi = len(tiles_for_region(PLAN.layout_for((24, 20, 16)), ROI))
    assert info["tiles_requested"] == 6 * per_roi
    assert info["tiles_decoded"] == 3 * per_roi  # duplicates deduplicated
    assert len(got["groups"]) == 1 and got["groups"][0]["n_requests"] == 3
    # tile-granular reads share the same cache: every tile hits now
    tiles = s.read_tiles("a0", tiles_for_region(PLAN.layout_for((24, 20, 16)),
                                                ROI))
    rtiles = r.read_tiles("a0", list(tiles))
    assert all(tiles[t].tobytes() == rtiles[t].tobytes() for t in tiles)


def test_overwrite_invalidates_cache_and_retires_old_generation(stores):
    s, r = stores
    x1, x2 = _field(20), _field(21)
    s.write("x", x1, EB)
    r.put("x", _payload(s, "x"))
    for store in (s, r):
        store.read_roi("x", ROI)  # populate the cache with x1 tiles
    p1 = s.info("x")["payload"]
    s.write("x", x2, EB)
    r.put("x", _payload(s, "x"))
    p2 = s.info("x")["payload"]
    assert p1 != p2 and ".g" in p2
    assert not (s.root / p1).exists()  # retired after the swap
    assert _manifest(s) == _manifest(r)
    assert s.read_roi("x", ROI).tobytes() == r.read_roi("x", ROI).tobytes()
    frames = [_field(22 + t, (8, 8, 8)) for t in range(2)]
    s.write_chain("c", frames, EB)
    c1 = s.info("c")["payload"]
    first = s.read("c")
    s.write_chain("c", frames, EB)
    c2 = s.info("c")["payload"]
    assert c1 != c2 and ".g" in c2 and not (s.root / c1).exists()
    assert s.n_frames("c") == 2 and s.read("c").tobytes() == first.tobytes()


def test_open_retires_crash_orphans(stores, tmp_path):
    s, _ = stores
    s.write("x", _field(30), EB)
    s.write("x", _field(31), EB)  # live payload is now generation-suffixed
    live = s.info("x")["payload"]
    want = s.read("x")
    s.close()
    pdir = tmp_path / "port" / "payload"
    orphan = pdir / "x.g9.lopc"
    orphan.write_bytes(b"\x00" * 64)
    torn = tmp_path / "port" / "manifest.json.tmp"
    torn.write_bytes(b"{")
    tmp_payload = pdir / "x.g9.lopc.tmp"
    tmp_payload.write_bytes(b"\x00" * 16)
    re = LopcStore.open(tmp_path / "port", device="cpu")
    try:
        assert not orphan.exists() and not tmp_payload.exists()
        assert re.info("x")["payload"] == live
        assert re.read("x").tobytes() == want.tobytes()
    finally:
        re.close()


def test_full_read_with_nonfinite_cells_and_persistence(stores):
    s, r = stores
    x = _field(40)
    x[3, 4, 5] = np.nan
    x[0, 0, 0] = np.inf
    s.write("x", x, EB)
    r.write("x", x, EB)
    assert _payload(s, "x") == _payload(r, "x")
    full = r.read("x")
    assert s.read("x").tobytes() == full.tobytes()
    s.close()
    re = LopcStore.open(s.root, device="cpu")
    try:
        got = re.read_roi("x", (slice(2, 6), slice(3, 6), slice(4, 8)))
        assert got.tobytes() == np.ascontiguousarray(
            full[2:6, 3:6, 4:8]).tobytes()
        assert re.read("x").tobytes() == full.tobytes()
    finally:
        re.close()


def test_append_frame_bytes_match_whole_chain_compress(stores):
    s, _ = stores
    frames = [_field(50 + t, (12, 10, 8)) for t in range(5)]
    whole = ref_temporal.compress_chain(frames, 1e-1, mode="abs",
                                        plan=REF_PLAN, keyframe_interval=2)
    assert whole == temporal.compress_chain(
        frames, 1e-1, mode="abs", plan=PLAN, keyframe_interval=2,
        device="cpu")
    c3 = bitstream.read_container_v3(whole)
    s.write_chain("ch", frames[:1], 1e-1, mode="abs", keyframe_interval=2)
    for f in frames[1:]:
        s.append_frame("ch", f)
    e = s.info("ch")
    payload = _payload(s, "ch")
    assert s.n_frames("ch") == 5
    for t, fe in enumerate(e["frames"]):
        assert fe["kind"] == c3.entries[t].kind
        assert payload[fe["off"]:fe["off"] + fe["len"]] == \
            c3.frame_payload(t), f"frame {t} bytes differ from compress_chain"
    dec = ref_temporal.decompress_chain(whole, plan=REF_PLAN)
    for t in range(5):
        assert s.read_frame("ch", t).tobytes() == dec[t].tobytes()
    assert s.read("ch").tobytes() == dec.tobytes()


def test_read_frame_replays_only_the_keyframe_run(stores):
    s, _ = stores
    frames = [_field(60 + t, (12, 10, 8)) for t in range(6)]
    s.write_chain("ch", frames, 1e-1, mode="abs", keyframe_interval=3)
    s.close()  # a fresh FileSource with zeroed byte accounting
    re = LopcStore.open(s.root, device="cpu")
    try:
        re.read_frame("ch", 4)  # keyframe 3 + residual 4
        view = re._readers["ch"][1]
        assert view.source.bytes_read == sum(
            view.entries[t].length for t in (3, 4))
    finally:
        re.close()


def test_append_frame_validates(stores):
    s, _ = stores
    frames = [_field(70 + t, (10, 8, 8)) for t in range(2)]
    s.write_chain("ch", frames, EB)
    with pytest.raises(ValueError, match="appended frame"):
        s.append_frame("ch", _field(72, (8, 8, 8)))
    with pytest.raises(ValueError, match="pinned bin width"):
        s.append_frame("ch", frames[0] * 1e-3)
    assert s.append_frame("ch", frames[0] * 2.0) == 2
    assert s.n_frames("ch") == 3


def test_kind_name_and_plan_errors(stores, tmp_path):
    s, _ = stores
    s.write("snap", _field(80), EB)
    s.write_chain("ch", [_field(81, (8, 8, 8))], EB)
    with pytest.raises(KeyError, match="no array"):
        s.read_roi("missing", ROI)
    with pytest.raises(ValueError, match="chain"):
        s.read_roi("ch", ROI)
    with pytest.raises(ValueError, match="snapshot"):
        s.read_frame("snap", 0)
    with pytest.raises(ValueError, match="bad array name"):
        s.write("no/slashes", _field(82), EB)
    with pytest.raises(ValueError):
        s.put("junk", b"not a container")
    with pytest.raises(ValueError, match="step"):
        s.read_roi("snap", (slice(0, 10, 2), slice(0, 3), slice(0, 3)))
    s.delete("snap")
    assert s.names() == ["ch"]
    with pytest.raises(KeyError):
        s.read("snap")
    with pytest.raises(FileNotFoundError):
        LopcStore.open(tmp_path / "nowhere", device="cpu")
    with pytest.raises(FileExistsError):
        LopcStore.create(tmp_path / "port", device="cpu")
    with pytest.raises(ValueError, match="plan"):
        LopcStore.open(tmp_path / "port", plan=CompressionPlan((4, 4, 4)),
                       device="cpu")
    LopcStore.open(tmp_path / "port", plan=PLAN, device="cpu").close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LopcStore.open(tmp_path / "port")  # the default is the card


def test_tile_cache_unit():
    cache = TileCache(max_bytes=100)
    a = np.arange(10, dtype=np.float64)  # 80 bytes
    cache.put(("x", 0, 1), a)
    assert cache.get(("x", 0, 1)) is not None
    assert cache.get(("x", 1, 1)) is None
    cache.put(("x", 1, 1), a)  # over budget: evicts the LRU entry
    assert cache.stats()["evictions"] == 1
    assert cache.get(("x", 0, 1)) is None
    cache.invalidate("x")
    assert cache.stats()["entries"] == 0
    got = cache.stats()
    assert got["hits"] == 1 and got["misses"] == 2
    cache.put(("y", 0, 1), np.zeros(1000))  # larger than the budget
    assert cache.get(("y", 0, 1)) is None
    with pytest.raises(ValueError):
        TileCache(max_bytes=-1)
    roomy = TileCache(max_bytes=1000)
    roomy.put(("v", 0, 1), np.ones((4, 10))[0])
    assert roomy.get(("v", 0, 1)).base is None
    assert not roomy.get(("v", 0, 1)).flags.writeable


def test_store_reads_equal_the_engine_decode(stores):
    """Region semantics (negative, clamped, empty slices) equal the
    port's ``decompress_roi`` and the reference's."""
    s, _ = stores
    s.write("x", _field(90), EB)
    blob = _payload(s, "x")
    for region in [(slice(-6, None), slice(0, 400), slice(None)),
                   (slice(5, 5), slice(0, 3), slice(2, 9)),
                   (slice(0, 24), slice(3, 4), slice(-1, None))]:
        want = ref_engine.decompress_roi(blob, region, plan=REF_PLAN)
        got = s.read_roi("x", region)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
        assert engine.decompress_roi(blob, region, plan=PLAN,
                                     device="cpu").tobytes() == got.tobytes()
