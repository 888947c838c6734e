"""The port's distributed compression (``repro_torch.distributed``) on the
CPU, against the unsharded engine of both packages.

Sharded tile batches run on 2 and 3 gloo ranks, each rank a subprocess
that rendezvouses through a ``FileStore`` in the test's temporary
directory (no TCP port, so parallel test workers never collide) and runs
torch on one intra-op thread.  Every rank must return the same blobs,
byte-equal to the port's unsharded ``compress_many`` and to the
reference's ``repro.engine.compress_many``: the reference's own sharded
path raises on this JAX version, so the unsharded bytes are the oracle.
The cases cover the reference test's fields, the 4x4x4-tile cross-tile
ramp (halo rounds across rank blocks), an adaptive f64 field (the int64
ordered state), the plain path (staged and fused), the order path's
compacted download, a field whose large subbins sit in one rank's block
(the group's subbin width), a batch whose capacity does not divide by 3
(replicated, no collective), a 2-frame chain through ``put=`` and
``Router(mesh=...)``'s shard payloads.  The gradient half is held to the
reference bit for bit, and ``compressed_pod_psum`` on 4 ranks of a
(2, 2) ("pod", "data") mesh to a numpy model of the rank sum.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import engine, temporal
from repro_torch.cluster import LocalCluster
from repro_torch.core import bitstream
from repro_torch.data.fields import make_field_sequence, make_scientific_field
from repro_torch.distributed import compression as dc
from repro_torch.engine.plan import CompressionPlan

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
EB = 1e-2
RANK_TIMEOUT_S = 300
# capacity classes 12 * 2**k: every batch splits over 2 and over 3 ranks
BATCH_12 = {"batch_tiles": 12}
ROUTER_PLAN = {"tile_shape": (8, 8, 8), "batch_tiles": 12}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- cases

def _ramp(tiles: int) -> np.ndarray:
    """``tiles``^3 4x4x8 tiles falling in linear index inside one bin
    (``tests/test_torch_resident.py``)."""
    shape = (4 * tiles, 4 * tiles, 8 * tiles)
    return -np.arange(np.prod(shape), dtype=np.float64).reshape(shape) * 1e-9


def _staircase() -> np.ndarray:
    """``test_torch_tda.staircase(np.float64)``: adaptive f64, whose one
    8-byte subbin climb sits in tile 1 (every other tile's subbins are
    below 4), so rank 0's block alone needs the wide section."""
    rng = np.random.default_rng(0)
    n = 4096
    x = np.concatenate([rng.standard_normal(n) for _ in range(5)]
                       + [np.linspace(0.0, 0.05, n)])
    for t in range(1, 6):
        w = rng.uniform(-0.5, 0.5)
        x[t * n] = w
        x[t * n - 1] = w + 1e-9
    return x


def shard_cases() -> dict:
    """name -> (fields, eb, keywords); ``plan`` as a dict of plan
    arguments, for either package."""
    rng = np.random.default_rng(0)
    tile8 = {"tile_shape": (8, 8, 8), "batch_tiles": 12}
    turb = [make_scientific_field("turbulence", s, np.dtype(np.float32), seed=i)
            for i, s in enumerate(((20, 18, 16), (9, 30, 17), (12, 12, 12)))]
    return {
        # the reference test's fields on the default plan: capacity 8,
        # split by 2 ranks, replicated on 3
        "reference-fields": ([rng.standard_normal((15, 12, 9)),
                              rng.standard_normal((8, 50))], EB, {}),
        "cross-tile-ramp": ([_ramp(4)], 1.0, {
            "mode": "abs", "plan": {"tile_shape": (4, 4, 8), **BATCH_12}}),
        "adaptive-f64": ([make_scientific_field(
            "gaussians", (24, 20, 16), np.dtype(np.float64), seed=5)], EB,
            {"adaptive_eb": "tda", "plan": tile8}),
        "adaptive-f32": ([turb[0]], EB, {"adaptive_eb": "tda", "plan": tile8}),
        "plain-staged": (turb, EB, {"preserve_order": False,
                                    "encode_path": "staged", "plan": tile8}),
        "plain-fused": (turb, EB, {"preserve_order": False,
                                   "encode_path": "fused", "plan": tile8}),
        "order-fused": (turb, EB, {"encode_path": "fused", "plan": tile8}),
        "large-subbins-in-one-block": ([_staircase()], EB, {
            "adaptive_eb": "tda", "plan": BATCH_12}),
    }


def chain_case():
    frames = make_field_sequence("advect", "gaussians", (16, 12, 10), 2,
                                 np.dtype(np.float32), seed=12)
    return frames, EB, {"keyframe_interval": 2,
                        "plan": {"tile_shape": (8, 8, 8), **BATCH_12}}


def router_field() -> np.ndarray:
    """``tests/test_torch_cluster.py``'s field: one NaN rides the sidecar."""
    x = np.random.default_rng(0).standard_normal((24, 20, 16)).astype(np.float32)
    x[1, 2, 3] = np.nan
    return x


def port_kw(kw: dict) -> dict:
    kw = dict(kw)
    if "plan" in kw:
        kw["plan"] = CompressionPlan(**kw["plan"])
    return kw


def ref_kw(kw: dict) -> dict:
    from repro.engine.plan import CompressionPlan as RefPlan

    kw = dict(kw)
    if "plan" in kw:
        kw["plan"] = RefPlan(**kw["plan"])
    return kw


def cluster_payloads(cl, name: str) -> dict:
    return {i: (w.store.root / w.store.info(name)["payload"]).read_bytes()
            for i, w in enumerate(cl.workers) if name in w.store.names()}


# ------------------------------------------------------------ rank runs

_RANK = textwrap.dedent("""
    import pickle, sys
    from pathlib import Path
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, out, tests = sys.argv[3], Path(sys.argv[4]), sys.argv[5]
    sys.path.insert(0, tests)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch import temporal
        from repro_torch.cluster import LocalCluster
        from repro_torch.distributed import (_collectives,
                                             compress_fields_sharded,
                                             make_tile_put)
        from repro_torch.engine import device
        import test_torch_distributed as T

        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        # each block's subbin maximum, before the group's MAX
        seen, real_max = [], device.sub_max
        device.sub_max = lambda s: seen.append(real_max(s)) or seen[-1]
        res = {"blobs": {}, "collectives": {}, "sub_max": {}}
        for name, (fields, eb, kw) in T.shard_cases().items():
            _collectives.reset_counts()
            seen.clear()
            res["blobs"][name] = compress_fields_sharded(
                fields, eb, mesh, device="cpu", **T.port_kw(kw))
            res["collectives"][name] = dict(_collectives.COUNTS)
            res["sub_max"][name] = list(seen)
        frames, eb, kw = T.chain_case()
        res["chain"] = temporal.compress_chains(
            [frames], eb, put=make_tile_put(mesh), device="cpu",
            **T.port_kw(kw))
        plan = T.port_kw({"plan": T.ROUTER_PLAN})["plan"]
        with LocalCluster(out.parent / f"cluster{rank}", 4, plan=plan,
                          n_replicas=2, backoff=0.0, device="cpu",
                          mesh=mesh) as cl:
            cl.router.write("x", T.router_field(), T.EB)
            res["router"] = T.cluster_payloads(cl, "x")
        out.write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()
""")


def run_ranks(world: int, root: Path, script: str, *args) -> list:
    """Run ``script`` on ``world`` gloo ranks (one subprocess each, one
    ``FileStore`` in ``root``) -> each rank's unpickled result file."""
    root.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    outs = [root / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world),
         str(root / "filestore"), str(outs[r]), str(HERE), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return [pickle.loads(o.read_bytes()) for o in outs]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 2- and 3-rank runs, once per module."""
    root = tmp_path_factory.mktemp("ranks")
    return {w: run_ranks(w, root / f"world{w}", _RANK) for w in (2, 3)}


@pytest.fixture(scope="module")
def unsharded():
    blobs = {name: engine.compress_many(fields, eb, device="cpu", **port_kw(kw))
             for name, (fields, eb, kw) in shard_cases().items()}
    frames, eb, kw = chain_case()
    blobs["chain"] = temporal.compress_chains([frames], eb, device="cpu",
                                              **port_kw(kw))
    return blobs


# ------------------------------------------------------------ sharded path

@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", sorted(shard_cases()))
def test_sharded_blobs_equal_unsharded(ranks, unsharded, world, case):
    for r, res in enumerate(ranks[world]):
        assert res["blobs"][case] == unsharded[case], (world, r)


@pytest.mark.parametrize("case", sorted(shard_cases()))
def test_unsharded_blobs_equal_reference(unsharded, case):
    from repro import engine as ref_engine

    fields, eb, kw = shard_cases()[case]
    assert unsharded[case] == ref_engine.compress_many(fields, eb, **ref_kw(kw))


def test_batches_split_or_replicate_by_capacity(ranks):
    """Capacity 8 splits over 2 ranks and runs whole on 3, with no
    collective; capacity classes of 12 split over both."""
    for world, split in ((2, True), (3, False)):
        for res in ranks[world]:
            assert bool(res["collectives"]["reference-fields"]) is split
            assert res["collectives"]["cross-tile-ramp"]["all_gather"] > 0


def test_subbin_width_is_the_groups_maximum(ranks, unsharded):
    """The staircase's 8-byte climb sits in rank 0's block: the other
    ranks' own maxima fit 16 bits, yet every rank writes 8-byte subbin
    sections, as the unsharded engine does."""
    case = "large-subbins-in-one-block"
    c = bitstream.read_container_v2(unsharded[case][0])
    assert c.stream_words()[1] == 8
    for world in (2, 3):
        maxima = [res["sub_max"][case] for res in ranks[world]]
        assert max(maxima[0]) >= 2**31, maxima
        assert all(max(m) < 2**15 for m in maxima[1:]), maxima
        assert all(res["collectives"][case]["all_reduce"] == 1
                   for res in ranks[world])


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_chain_equals_unsharded(ranks, unsharded, world):
    from repro import temporal as ref_temporal

    frames, eb, kw = chain_case()
    assert unsharded["chain"] == ref_temporal.compress_chains(
        [frames], eb, **ref_kw(kw))
    for res in ranks[world]:
        assert res["chain"] == unsharded["chain"]


@pytest.mark.parametrize("world", [2, 3])
def test_router_mesh_scatters_the_unsharded_payloads(ranks, tmp_path, world):
    with LocalCluster(tmp_path / "one", 4,
                      plan=CompressionPlan(**ROUTER_PLAN), n_replicas=2,
                      backoff=0.0, device="cpu") as cl:
        cl.router.write("x", router_field(), EB)
        want = cluster_payloads(cl, "x")
    assert len(want) >= 2
    for res in ranks[world]:
        assert res["router"] == want


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "filestore"), 1), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_tile_put_places_blocks_and_checks_its_device(world1):
    put = dc.make_tile_put(world1, device="cpu")
    assert (put.rank, put.world) == (0, 1) and put.group is not None
    t = put(np.arange(6, dtype=np.int32).reshape(2, 3))
    assert t.device.type == "cpu" and t.tolist() == [[0, 1, 2], [3, 4, 5]]
    block = put.block(8)
    assert (block.lo, block.hi, block.capacity) == (0, 8, 8)
    # world 1 still runs the sharded solve and its collectives
    fields, eb, kw = shard_cases()["cross-tile-ramp"]
    assert dc.compress_fields_sharded(fields, eb, world1, device="cpu",
                                      **port_kw(kw)) == \
        engine.compress_many(fields, eb, device="cpu", **port_kw(kw))
    with pytest.raises(ValueError, match="put placed"):
        engine.compress_many(fields, eb, device="cpu",
                             put=lambda a: torch.from_numpy(a).to("meta"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        dc.make_tile_put(object())


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_quantize_is_bit_equal_to_reference(dtype):
    import jax.numpy as jnp
    from repro.distributed import compression as ref

    g = np.random.default_rng(1).standard_normal((37, 21)).astype(np.float32)
    gj = jnp.asarray(g).astype(getattr(jnp, dtype))
    gt = torch.from_numpy(g).to(getattr(torch, dtype))
    q_r, s_r = ref._quantize_leaf(gj)
    q, s = dc._quantize_leaf(gt)
    assert np.array_equal(np.asarray(q_r), q.numpy())
    assert np.asarray(s_r).tobytes() == s.numpy().tobytes()
    d_r = np.asarray(ref._dequantize_leaf(q_r, s_r))
    assert d_r.tobytes() == dc._dequantize_leaf(q, s).numpy().tobytes()


def test_error_feedback_is_bit_equal_to_reference_over_three_steps():
    import jax.numpy as jnp
    from repro.distributed import compression as ref

    rng = np.random.default_rng(2)
    steps = [{"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": [rng.standard_normal(8).astype(np.float32),
                    rng.standard_normal((4, 4)).astype(np.float32)]}
             for _ in range(3)]
    def as_ref(t):
        return {"w": jnp.asarray(t["w"]),
                "b": [jnp.asarray(t["b"][0]).astype(jnp.bfloat16),
                      jnp.asarray(t["b"][1])]}

    def as_port(t):
        return {"w": torch.from_numpy(t["w"]),
                "b": [torch.from_numpy(t["b"][0]).to(torch.bfloat16),
                      torch.from_numpy(t["b"][1])]}

    f_r, f = ref.make_error_feedback_compressor(), \
        dc.make_error_feedback_compressor()
    st_r = {"ef": ref.init_error_feedback(as_ref(steps[0])), "k": 1}
    st = {"ef": dc.init_error_feedback(as_port(steps[0])), "k": 1}
    for grads in steps:
        g_r, st_r = f_r(as_ref(grads), st_r)
        g, st = f(as_port(grads), st)
        for a, b in ((g_r["w"], g["w"]), (g_r["b"][0], g["b"][0]),
                     (g_r["b"][1], g["b"][1]), (st_r["ef"]["w"], st["ef"]["w"]),
                     (st_r["ef"]["b"][0], st["ef"]["b"][0]),
                     (st_r["ef"]["b"][1], st["ef"]["b"][1])):
            a = np.asarray(a.astype(jnp.float32))
            assert a.tobytes() == b.to(torch.float32).numpy().tobytes()
        assert st["k"] == 1 and g["b"][0].dtype == torch.bfloat16


_PSUM = textwrap.dedent("""
    import pickle, sys
    from pathlib import Path
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, out = sys.argv[3], Path(sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.distributed import compressed_pod_psum

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
        x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
        pod, data = divmod(rank, 2)  # the mesh's row-major rank layout
        assert list(mesh.get_coordinate()) == [pod, data], mesh.get_coordinate()
        local = x[4 * pod: 4 * pod + 4, 64 * data: 64 * data + 64]
        y = compressed_pod_psum(torch.from_numpy(local.copy()),
                                mesh.get_group("pod"))
        out.write_bytes(pickle.dumps((pod, data, y.numpy())))
    finally:
        dist.destroy_process_group()
""")


def test_compressed_pod_psum_matches_its_numpy_model(tmp_path):
    res = run_ranks(4, tmp_path, _PSUM)
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    exact = x.reshape(2, 4, 128).sum(0)
    for pod, data, y in res:
        cols = slice(64 * data, 64 * data + 64)
        blocks = [x[4 * p: 4 * p + 4, cols] for p in range(2)]
        # the model: per-pod scale, the max of them, requantize, int32 sum
        scales = [np.maximum(np.abs(b).max(), np.float32(1e-30))
                  / np.float32(127.0) for b in blocks]
        smax = np.float32(max(scales))
        total = sum(np.clip(np.rint(b / smax), -127, 127).astype(np.int8)
                    .astype(np.int32) for b in blocks)
        model = total.astype(np.float32) * smax
        assert y.dtype == np.float32 and y.tobytes() == model.tobytes()
        rel = np.abs(y - exact[:, cols]).max() / np.abs(exact[:, cols]).max()
        assert rel < 0.02, rel
