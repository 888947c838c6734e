"""The port's numerical core, codecs and host modules against the JAX
reference: bit equality for arrays, byte equality for streams.

Inputs are made from seeds with numpy and handed to both packages; the
port runs on the CPU (``device="cpu"`` / CPU tensors), the reference
under JAX on the CPU with x64 on (``import repro`` turns it on).
"""
from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitstream as ref_bitstream
from repro.core import floatbits as ref_fb
from repro.core import quantize as ref_q
from repro.core import topology as ref_topo
from repro.engine import buckets as ref_buckets
from repro.engine import halo as ref_halo
from repro.engine.plan import CompressionPlan as RefPlan
from repro_torch.codecs import bitshuffle as pt_bs
from repro_torch.codecs import rze as pt_rze
from repro_torch.codecs import transforms as pt_tr
from repro_torch.core import bitstream as pt_bitstream
from repro_torch.core import floatbits as pt_fb
from repro_torch.core import quantize as pt_q
from repro_torch.core import topology as pt_topo
from repro_torch.engine import buckets as pt_buckets
from repro_torch.engine import halo as pt_halo
from repro_torch.engine.plan import CompressionPlan as PtPlan

# repro.codecs re-exports functions under its submodules' names
ref_bs = importlib.import_module("repro.codecs.bitshuffle")
ref_rze = importlib.import_module("repro.codecs.rze")
ref_tr = importlib.import_module("repro.codecs.transforms")

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
SIGNED = {16: np.int16, 32: np.int32, 64: np.int64}
UNSIGNED = {16: np.uint16, 32: np.uint32, 64: np.uint64}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and a.tobytes() == b.tobytes())


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


# ------------------------------------------------------------- floatbits

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_floatbits_edge_values(dtype, rng):
    fi = np.finfo(dtype)
    edge = np.array([0.0, -0.0, fi.smallest_subnormal, -fi.smallest_subnormal,
                     fi.tiny, -fi.tiny, fi.tiny * 0.5, fi.max, -fi.max,
                     1.0, -1.0], dtype)
    x = np.concatenate([edge, (rng.standard_normal(200) * 1e3).astype(dtype)])
    want = np.asarray(ref_fb.float_to_ordered(jnp.asarray(x)))
    got = pt_fb.float_to_ordered(_t(x)).numpy()
    assert _bits_equal(got, want)
    back_ref = np.asarray(ref_fb.ordered_to_float(jnp.asarray(want), dtype))
    back = pt_fb.ordered_to_float(_t(got), _t(x).dtype).numpy()
    assert _bits_equal(back, back_ref)
    k = rng.integers(0, 5, x.size)
    nxt = pt_fb.nextafter_k(_t(x[np.abs(x) < fi.max]), _t(k[np.abs(x) < fi.max]))
    nxt_ref = ref_fb.nextafter_k(jnp.asarray(x[np.abs(x) < fi.max]),
                                 jnp.asarray(k[np.abs(x) < fi.max]))
    assert _bits_equal(nxt.numpy(), np.asarray(nxt_ref))


# -------------------------------------------------------------- quantize

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decode_base_and_quantize_per_tile_eps(dtype, rng):
    tiles = 6
    scales = np.array([1e-3, 1e-2, 0.3, 1.0, 7.5, 1e3])
    x = (rng.standard_normal((tiles, 64)) * scales[:, None] * 50).astype(dtype)
    eps = np.array([ref_q.effective_eps(s) for s in scales])
    want = np.asarray(ref_q.quantize_broadcast(jnp.asarray(x),
                                               jnp.asarray(eps)[:, None], dtype))
    got = pt_q.quantize_broadcast(_t(x), _t(eps)[:, None],
                                  _t(x).dtype).numpy()
    assert _bits_equal(got, want)
    base_ref = np.asarray(ref_q.decode_base(jnp.asarray(want),
                                            jnp.asarray(eps)[:, None], dtype))
    base = pt_q.decode_base(_t(got), _t(eps)[:, None], _t(x).dtype).numpy()
    assert _bits_equal(base, base_ref)


def test_decode_base_near_exact_bin_limit(rng):
    lim = int(ref_q.F64_EXACT_BIN_LIMIT)
    bins = np.concatenate([
        np.array([lim, lim - 1, -lim, -lim + 1, 0, 1, -1], np.int64),
        rng.integers(-lim, lim, 200, dtype=np.int64)])
    for eps in (1e-11, 3.7e-7, 0.125, 1e3):
        want = np.asarray(ref_q.decode_base(jnp.asarray(bins), eps, np.float64))
        got = pt_q.decode_base(_t(bins), eps, torch.float64).numpy()
        assert _bits_equal(got, want)
    b32 = rng.integers(-(2**30), 2**30, 300).astype(np.int32)
    for eps in (1e-7, 1e-3, 2.5):
        want = np.asarray(ref_q.decode_base(jnp.asarray(b32), eps, np.float32))
        got = pt_q.decode_base(_t(b32), eps, torch.float32).numpy()
        assert _bits_equal(got, want)


def test_quantize_helpers(rng):
    x = rng.standard_normal(50).astype(np.float32) * 4
    for mode in ("abs", "noa"):
        assert (pt_q.abs_bound_from_mode(x, 1e-2, mode)
                == ref_q.abs_bound_from_mode(x, 1e-2, mode))
    assert pt_q.effective_eps(0.3) == ref_q.effective_eps(0.3)
    for dt in (np.float32, np.float64):
        assert np.dtype(pt_q.bin_dtype_for(dt)) == np.dtype(ref_q.bin_dtype_for(dt))
        assert pt_q.max_abs_bin(dt) == ref_q.max_abs_bin(dt)
    with pytest.raises(ValueError):
        pt_q.check_bin_range(np.array([1e30], np.float32), 1e-6)


# -------------------------------------------------------------- topology

@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("shape", [(7, 6, 5), (9, 8), (40,)])
def test_order_flags(kind, shape, rng):
    x = rng.standard_normal(shape)
    if kind == "ties":  # many exact ties, and signed zeros
        x = np.round(x * 2) / 2
        x[x == 0] = np.where(rng.random((x == 0).sum()) < 0.5, 0.0, -0.0)
    bins = np.round(x * 1.5).astype(np.int32)
    want = np.asarray(ref_topo.order_flags(jnp.asarray(bins), jnp.asarray(x)))
    got = pt_topo.order_flags(_t(bins), _t(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want)
    assert got.max() < 2**14
    for nd in (1, 2, 3):
        assert np.array_equal(pt_topo.offsets(nd), ref_topo.offsets(nd))
        assert np.array_equal(pt_topo.tie_breaker(nd), ref_topo.tie_breaker(nd))


# ---------------------------------------------------------------- codecs

@pytest.mark.parametrize("w", [16, 32, 64])
def test_codecs_match_reference(w, rng):
    sdt, udt = SIGNED[w], UNSIGNED[w]
    length = 4 * w
    vals = rng.integers(-300, 300, (3, length)).astype(sdt)
    vals[1, ::3] = np.iinfo(sdt).min  # wrapping deltas
    vals[2] = 0
    vals[2, 5] = 17
    d_ref = np.asarray(ref_tr.zigzag_encode(ref_tr.delta_encode(jnp.asarray(vals))))
    d = pt_tr.zigzag_encode(pt_tr.delta_encode(_t(vals)))
    assert np.array_equal(d.numpy().view(udt), d_ref)
    back = pt_tr.delta_decode(pt_tr.zigzag_decode(d))
    back_ref = np.asarray(ref_tr.delta_decode(ref_tr.zigzag_decode(jnp.asarray(d_ref))))
    assert np.array_equal(back.numpy(), back_ref) and np.array_equal(back.numpy(), vals)

    words = d_ref
    sh_ref = np.asarray(ref_bs.bitshuffle(jnp.asarray(words)))
    sh = pt_bs.bitshuffle(_t(words.view(sdt)))
    assert np.array_equal(sh.numpy().view(udt), sh_ref)
    assert np.array_equal(sh.numpy().view(udt), pt_bs.np_bitshuffle(words))
    assert np.array_equal(sh_ref, ref_bs.np_bitshuffle(words))
    assert np.array_equal(pt_bs.bitunshuffle(sh).numpy().view(udt), words)
    assert np.array_equal(pt_bs.np_bitunshuffle(sh.numpy().view(udt)), words)

    bm_ref, cnt_ref = ref_rze.rze_bitmap(jnp.asarray(sh_ref))
    bm, cnt = pt_rze.rze_bitmap(sh)
    assert np.array_equal(bm.numpy().view(udt), np.asarray(bm_ref))
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_ref))
    packed = np.zeros_like(sh_ref)
    for r in range(sh_ref.shape[0]):
        nz = sh_ref[r][sh_ref[r] != 0]
        packed[r, : nz.size] = nz
    exp_ref = np.asarray(ref_rze.rze_decode(bm_ref, jnp.asarray(packed)))
    exp = pt_rze.rze_decode(bm, _t(packed.view(sdt)))
    assert np.array_equal(exp.numpy().view(udt), exp_ref)
    assert np.array_equal(exp_ref, sh_ref)


def test_host_rze_helpers(rng):
    stream = (rng.random(300) < 0.2).astype(np.uint8) * rng.integers(1, 255, 300).astype(np.uint8)
    for fa, fb in ((pt_rze.np_rze_bytes, ref_rze.np_rze_bytes),):
        a, b = fa(stream), fb(stream)
        assert all(np.array_equal(p, q) for p, q in zip(a, b))
    bm, nz = pt_rze.np_rze_bytes(stream)
    assert np.array_equal(pt_rze.np_unrze_bytes(bm, nz, stream.size), stream)
    words = np.repeat(rng.integers(0, 4, 40).astype(np.uint32), 3)
    km, kept = pt_rze.np_repeat_eliminate(words)
    km_r, kept_r = ref_rze.np_repeat_eliminate(words)
    assert np.array_equal(km, km_r) and np.array_equal(kept, kept_r)
    assert np.array_equal(
        pt_rze.np_repeat_restore(km, kept, words.size, np.uint32), words)


# ----------------------------------------------------- plan, halo, buckets

@pytest.mark.parametrize("shape,tile", [((13, 11, 9), None), ((40, 28), None),
                                        ((500,), None), ((13, 11, 9), (4, 4, 8)),
                                        ((30, 17), (4, 4, 8))])
def test_layouts_and_halo_tables(shape, tile):
    ref_l = RefPlan(tile_shape=tile).layout_for(shape)
    pt_l = PtPlan(tile_shape=tile).layout_for(shape)
    assert (pt_l.tile, pt_l.grid, pt_l.canonical) == (ref_l.tile, ref_l.grid,
                                                     ref_l.canonical)
    idx, mask = pt_halo.neighbor_index(pt_l)
    idx_r, mask_r = ref_halo.neighbor_index(ref_l)
    assert np.array_equal(idx, idx_r) and np.array_equal(mask, mask_r)
    cap = pt_buckets.bucket_capacity(pt_l.n_tiles)
    g, gm = pt_halo.group_index((pt_l, pt_l), 2 * cap)
    g_r, gm_r = ref_halo.group_index((ref_l, ref_l), 2 * cap)
    assert np.array_equal(g, g_r) and np.array_equal(gm, gm_r)


def test_bucket_plans():
    for sizes in [(1,), (3, 200, 5), (127, 1, 1), tuple(range(1, 40))]:
        for floor in (4, 8, 16):
            assert (pt_buckets.plan_request_chunks(sizes, floor)
                    == ref_buckets.plan_request_chunks(sizes, floor))
    for n in (0, 1, 127, 128, 129, 1000, 5000):
        assert pt_buckets.plan_tile_chunks(n) == ref_buckets.plan_tile_chunks(n)
        assert pt_buckets.bucket_capacity(n) == ref_buckets.bucket_capacity(n)


# ------------------------------------------------------------ bitstream

@pytest.mark.parametrize("fname", ["fixture_v2.lopc", "fixture_v2_wide.lopc",
                                   "fixture_v2_adaptive.lopc"])
def test_v2_fixture_parses_and_reserializes(fname):
    blob = (DATA / fname).read_bytes()
    c = pt_bitstream.read_container_v2(blob)
    tiles = []
    for t in range(c.n_tiles):
        bins_b, sub_b = c.tile_payloads(t)
        out = []
        for sec in (bins_b, sub_b):
            bm, pk = pt_bitstream.deserialize_rze_section(sec)
            counts = (pk != 0).sum(axis=1)
            out.append(pt_bitstream.serialize_rze_section(bm, pk, counts))
        tiles.append(tuple(out))
    extra = {tag: c.extra_section(tag) for tag in c.extra}
    again = pt_bitstream.write_container_v2(c.header, c.tile_shape, c.grid,
                                            tiles, extra)
    assert again == blob
    r = ref_bitstream.read_container_v2(blob)
    assert r.stream_words() == c.stream_words()
    assert np.array_equal(r.eb_ladder(), c.eb_ladder())


# ----------------------------------------------------------------- guards

def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules if k.startswith('repro_torch')))\n"
    )
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 50
    # the serving stack's modules are reached too
    assert {"repro_torch.obs.trace", "repro_torch.obs.registry",
            "repro_torch.obs.recorder", "repro_torch.obs.export",
            "repro_torch.store.store", "repro_torch.store.cache",
            "repro_torch.service.service", "repro_torch.service.metrics",
            "repro_torch.launch.serve"} <= names
    # and the cluster's
    assert {"repro_torch.cluster", "repro_torch.cluster.protocol",
            "repro_torch.cluster.placement", "repro_torch.cluster.metrics",
            "repro_torch.cluster.worker",
            "repro_torch.cluster.router"} <= names
    # and the LM serving path's
    assert {"repro_torch.models.model", "repro_torch.models.convert",
            "repro_torch.models.mamba2", "repro_torch.models.rwkv6",
            "repro_torch.configs.qwen2_5_3b", "repro_torch.configs.lopc"} <= names
    # and the LM training path's
    assert {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.schedules", "repro_torch.runtime",
            "repro_torch.runtime.steps", "repro_torch.runtime.trainer",
            "repro_torch.data.pipeline", "repro_torch.launch.train"} <= names


def test_every_port_module_imports_first():
    """Each module of the port imports as the first one of the package
    (a script on the card may start from any of them): no import cycle
    depends on another module having been imported before."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                                 'repro_torch.')]\n"
        "for name in names:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 50


def test_entry_points_refuse_to_run_on_cpu_unasked():
    from repro_torch import engine

    x = np.zeros((4, 4), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.compress(x, 1e-2)
    blob = engine.compress(x, 1e-2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.decompress(blob)
    # the census, the ladder and the FF32 domain check upload numpy
    # inputs to the CUDA device unless asked for the CPU
    from repro_torch import tda
    from repro_torch.kernels import ops
    from repro_torch.tda import adaptive

    # the whole-field pipeline's decodes run on the card unless asked
    from repro_torch.codecs import pipeline

    ints = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    bins_payload = pipeline.encode_bins(ints)
    sub_payload = pipeline.encode_subbins(ints - 8)
    layout = engine.CompressionPlan().layout_for(x.shape)
    x3 = x.reshape(layout.canonical)
    for call in (lambda **kw: tda.critical_signature(x, **kw),
                 lambda **kw: tda.classify_critical_points(x, **kw),
                 lambda **kw: tda.critical_point_errors(x, x, **kw),
                 lambda **kw: tda.local_order_violations(x, x, **kw),
                 lambda **kw: tda.ladder_indices(x, layout, 0.1, **kw),
                 lambda **kw: adaptive.tile_relief(x3, layout, **kw),
                 lambda **kw: adaptive.tile_noise_scale(x3, layout, **kw),
                 lambda **kw: adaptive.critical_counts(x, layout, **kw),
                 lambda **kw: adaptive.critical_tiles(x, layout, **kw),
                 lambda **kw: adaptive.tighten_ladder(
                     x, layout, np.zeros(layout.n_tiles, np.uint8), 0.1, **kw),
                 lambda **kw: ops.ff32_domain_ok(x, 0.1, **kw),
                 lambda **kw: pipeline.decode_bins(bins_payload, 16, (4, 4),
                                                   torch.int32, **kw),
                 lambda **kw: pipeline.decode_subbins(sub_payload, 16, (4, 4),
                                                      torch.int32, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")


def test_arguments_outside_the_slice_name_their_roadmap_row():
    from repro_torch import engine

    x = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    # put (row 13, distributed) is ported: a placing callable must put
    # its tensor on the executor's device, and placement never changes
    # the bytes
    with pytest.raises(ValueError, match="put placed"):
        engine.compress_many([x], 1e-2, device="cpu", put=lambda a: a)
    assert engine.compress_many([x], 1e-2, device="cpu",
                                put=lambda a: torch.from_numpy(a)) == \
        engine.compress_many([x], 1e-2, device="cpu")
    # group_cb (row 12, the serving stack) is ported: one dict per group
    infos = []
    engine.compress_many([x], 1e-2, device="cpu", group_cb=infos.append)
    assert [i["kind"] for i in infos] == ["compress"]
    # v3 chains (row 10) are ported: the version byte routes a chain to
    # the (n_frames, *shape) stack, and a multi-frame chain's ROI raises
    # the reference's ValueError
    chain = (DATA / "fixture_v3.lopc").read_bytes()
    with pytest.raises(ValueError, match="pick a frame"):
        engine.decompress_roi(chain, (slice(0, 2),) * 3, device="cpu")
    from repro_torch import core

    want = np.load(DATA / "expected.npz")["v3"]
    got = core.decompress(chain, device="cpu")
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    # the reference's own argument errors
    with pytest.raises(ValueError, match="requires preserve_order=True"):
        engine.compress(x, 1e-2, preserve_order=False, adaptive_eb="tda",
                        device="cpu")
    with pytest.raises(ValueError):
        engine.compress(x, 1e-2, solver="nope", device="cpu")
