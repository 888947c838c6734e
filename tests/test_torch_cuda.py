"""Every hand-written CUDA kernel of the port against its plain PyTorch
version, on the card, bit for bit.

These tests compare the port with itself, so this file imports neither
jax nor the reference package: it runs on a machine that has a card and
no JAX.  Every test is marked ``cuda`` and skips where no CUDA device is
present.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are made from seeds with numpy.  The fused decode (kernels 3 and
3') and encode (kernels 2 and 4) also run over every pair of stream
widths, tiles that are not a whole number of chunks (the 1-D and 2-D
plan tiles), batch 1, an all-zero chunk, a chunk whose bitmap has every
bit set, and words at the zigzag and wrap extremes.  The BIT_4
transpose (kernel 8) runs 1, 2, 3 and 6104 chunks of words with every
bit pattern the CPU model tests (``test_torch_partition.bit4_words``),
and the value encode (kernel 4) the CPU model's adversarial cells
(``test_torch_partition.adversarial_cells``) at both store widths, with
and without bounds within 2x of the smallest normal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import quantize, topology
from repro_torch.core.floatbits import float_to_ordered
from repro_torch.kernels import LAUNCHES, TRANSFORM_LAUNCHES, reset_launches
from repro_torch.kernels import fused_decode as pt_fd
from repro_torch.kernels import fused_encode as pt_fe
from repro_torch.kernels import subbin_sweep as pt_ss
from test_torch_partition import F32_TINY, adversarial_cells, bit4_words

CHUNK = {2: 8192, 4: 4096, 8: 2048}
SIGNED = {2: np.int16, 4: np.int32, 8: np.int64}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py compares them there too)")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        idt = torch.int32 if a.element_size() == 4 else torch.int64
        a, b = a.view(idt), b.view(idt)
    return a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------ inputs

def _solve_inputs(rng, batch: int, tile):
    """A haloed subbin batch and order flags of tied random tiles."""
    h = tuple(t + 2 for t in tile)
    x = np.round(rng.standard_normal((batch,) + h) * 1.5) / 2
    bins = np.round(x).astype(np.int32)
    flags = np.stack([topology.order_flags(_t(b), _t(v)).numpy()
                      for b, v in zip(bins, x)])[:, 1:-1, 1:-1, 1:-1]
    sub_h = rng.integers(0, 4, (batch,) + h).astype(np.int32)
    return sub_h, np.ascontiguousarray(flags).astype(np.int32)


def _ints(rng, batch, elems, word):
    dt = SIGNED[word]
    hi = min(np.iinfo(dt).max, 2**40)
    base = np.cumsum(rng.integers(-3, 4, (batch, elems)), axis=1)
    vals = (base + rng.integers(-hi // 2, hi // 2, (batch, 1))).astype(dt)
    vals[0, : elems // 3] = 0            # zero runs -> sparse bitmaps
    vals[-1, 1::7] = np.iinfo(dt).min    # wrapping deltas
    return vals


def _extremes(batch, elems, word):
    """Words at the zigzag and wrap extremes: -2^(W-1), 2^(W-1) - 1, -1,
    0 and 1 in turn, so deltas wrap both ways."""
    info = np.iinfo(SIGNED[word])
    cycle = np.array([info.min, info.max, -1, 0, 1, info.min, 0, info.max],
                     dtype=SIGNED[word])
    return np.resize(cycle, (batch, elems)).astype(SIGNED[word])


def _values(rng, batch, elems, scale):
    """f32 interiors with NaN pad cells, one NaN pad row, non-finite
    cells, signed zeros, denormals and exact half-bin ties."""
    x = (rng.standard_normal((batch, elems)) * scale).astype(np.float32)
    x[:, elems - 37:] = np.nan          # tile pad
    x[-1] = np.nan                      # a pad tile
    x[0, 3], x[0, 4], x[0, 5] = np.inf, -np.inf, -0.0
    x[0, 6:40] = np.float32(1e-41) * np.arange(34)
    return x


def _pack(rows: np.ndarray) -> np.ndarray:
    """Front-pack each row's nonzero words, as the container stores them."""
    out = np.zeros_like(rows)
    for r in range(rows.shape[0]):
        nz = rows[r][rows[r] != 0]
        out[r, : nz.size] = nz
    return out


def _stream(ints: np.ndarray, transform: str):
    """(bitmap, front-packed words) rows of a (batch, elems) int batch,
    by the port's plain encode."""
    w = ints.dtype.itemsize
    bm, words, _ = pt_fe.encode_ints_plain(_t(ints), CHUNK[w], transform)
    return bm.numpy(), _pack(words.numpy())


def _streams(rng, batch, tile_elems, bins_word, subs_word, case="random"):
    """Bins (delta) and subbin (raw) streams of one case."""
    if case == "extremes":
        bins = _extremes(batch, tile_elems, bins_word)
        subs = _extremes(batch, tile_elems, subs_word)
    else:
        bins = _ints(rng, batch, tile_elems, bins_word) // 4
        subs = rng.integers(0, 9, (batch, tile_elems)).astype(SIGNED[subs_word])
        if case == "zero chunk":  # the first tile all zeros: empty rows
            bins[0], subs[0] = 0, 0
    streams = [*_stream(bins, "delta"), *_stream(subs, "raw")]
    if case == "full bitmap":  # every word of the first tile's rows nonzero
        for k, word in ((0, bins_word), (2, subs_word)):
            bm, pk = streams[k], streams[k + 1]
            cpt = bm.shape[0] // batch
            bm[:cpt] = -1
            pk[:cpt] = rng.integers(1, 2**15, pk[:cpt].shape).astype(pk.dtype)
            pk[:cpt] *= rng.choice(np.array([-1, 1], dtype=pk.dtype),
                                   pk[:cpt].shape)
    return streams


def _eps(batch, dtype):
    eps = np.array([1e-3, 2.5e-2, 0.7, 3.0]) if dtype == torch.float32 \
        else np.array([1e-9, 3e-4, 2.0, 0.5])
    return np.resize(eps, batch)


# ------------------------------------------------------ moved cases

@pytest.mark.parametrize("kernel", ["solve", "encode", "decode",
                                    "encode_values", "decode_plain"])
def test_cuda_kernel_matches_plain(rng, dev, kernel):
    if kernel == "solve":
        sub_h, flags = _solve_inputs(rng, 64, (16, 16, 64))
        args = (_t(sub_h).to(dev), _t(flags).to(dev))
        plain = pt_ss.solve_tiles_blockwise_plain(*args)
        got = pt_ss.solve_tiles_blockwise(*args)
    elif kernel == "encode":
        ints = _t(_ints(rng, 64, 16384, 2)).to(dev)
        plain = pt_fe.encode_ints_plain(ints, 8192, "delta")
        got = pt_fe.encode_ints_fused(ints, 8192, "delta")
    elif kernel == "encode_values":
        x = _t(_values(rng, 64, 16384, 30.0)).to(dev)
        eps = torch.full((64,), 1e-2, dtype=torch.float64, device=dev)
        plain = pt_fe.encode_values_plain(x, eps, 8192, torch.float32,
                                          torch.int16)
        got = pt_fe.encode_values_fused(x, eps, 8192, torch.float32,
                                        torch.int16)
    elif kernel == "decode_plain":
        bm, pk, _, _ = _streams(rng, 8, 16384, 2, 2)
        args = [_t(a).to(dev) for a in (bm, pk)]
        eps = torch.full((8,), 1e-3, dtype=torch.float64, device=dev)
        plain = (pt_fd.decode_tiles_plain(*args, None, None, eps, 16384,
                                          torch.float32),)
        got = (pt_fd.decode_tiles_fused(*args, None, None, eps, 16384,
                                        torch.float32),)
    else:
        args = [_t(a).to(dev) for a in _streams(rng, 8, 16384, 2, 2)]
        eps = torch.full((8,), 1e-3, dtype=torch.float64, device=dev)
        plain = (pt_fd.decode_tiles_plain(*args, eps, 16384, torch.float32),)
        got = (pt_fd.decode_tiles_fused(*args, eps, 16384, torch.float32),)
    for a, b in zip(got, plain):
        assert _bits_equal(a, b)


def _bins_values(x: np.ndarray, eps_abs: float):
    """The bins of ``x`` as numpy, beside ``x``."""
    return quantize.quantize(_t(x), eps_abs).numpy(), x


def _long_chain():
    """128x4x4 descending in x: one chain across the whole X extent."""
    x = -np.cumsum(np.full((128, 4, 4), 1e-9), axis=0)
    return _bins_values(x, 1.0)


def _serpentine(x: int, y: int, z: int):
    """(x, y, z) field constant in X whose values fall along a corridor
    that winds through the whole Y x Z plane inside one bin, the rest of
    the odd rows a wall in another bin: one chain through every corridor
    cell of every band's plane."""
    v = np.full((y, z), 3.0)
    step = 0
    for r in range(0, y, 2):
        cols = range(z) if r % 4 == 0 else range(z - 1, -1, -1)
        for c in cols:
            v[r, c] = -step * 1e-9
            step += 1
        if r + 1 < y:
            v[r + 1, cols[-1]] = -step * 1e-9
            step += 1
    return _bins_values(np.broadcast_to(v, (x, y, z)).copy(), 1.0)


def _in_tile_chain(ty: int, tz: int):
    """(24, ty, tz) field whose middle band falls along a 3-D
    boustrophedon through all of its 8 x ty x tz cells inside one bin,
    the other bands a wall in another bin: one chain of 8 * ty * tz - 1
    hops inside one tile of an inner band."""
    v = np.full((24, ty, tz), 3.0)
    step = 0
    for a in range(8):
        ys = range(ty) if a % 2 == 0 else range(ty - 1, -1, -1)
        for n, b in enumerate(ys):
            zs = range(tz) if (a * ty + n) % 2 == 0 else range(tz - 1, -1, -1)
            for c in zs:
                v[8 + a, b, c] = -step * 1e-9
                step += 1
    return _bins_values(v, 1.0)


def _front():
    """64x4x4 rising in X inside one bin, with X-row 0 falling in Z."""
    x = np.arange(64, dtype=np.float64)[:, None, None] * 1e-9 + np.zeros((64, 4, 4))
    x[0] = -np.arange(4, dtype=np.float64)[None, :] * 1e-12
    return _bins_values(x, 1.0)


def _words(rng, c: int) -> np.ndarray:
    w = rng.integers(0, 2**32, (c, 4096), dtype=np.uint64).astype(np.uint32)
    w[rng.random((c, 4096)) < 0.4] = 0
    w[0, :700] = 0  # a dead run: all-zero bitmap words
    return w


@pytest.mark.parametrize("kernel", ["solve_blockwise", "bitshuffle_u32",
                                    "bitunshuffle_u32", "rze_bitmap_u32"])
def test_cuda_whole_field_kernel_matches_plain(rng, dev, monkeypatch, kernel):
    from repro_torch.kernels import bitshuffle_kernel, ref, rze_kernel

    if kernel == "solve_blockwise":
        for bins, x in (_bins_values(rng.uniform(-1, 1, (37, 33, 29)), 0.5),
                        _long_chain(), _serpentine(16, 40, 150), _front()):
            flags = topology.order_flags(_t(bins).to(dev), _t(x).to(dev))
            got, got_sweeps = pt_ss.solve_blockwise(flags)
            want, want_sweeps = pt_ss.solve_blockwise_plain(flags)
            assert torch.equal(got, want) and got_sweeps == want_sweeps
        # a chain of 8191 hops in one tile, under the kernel's pass cap
        # and under a cap of 8 passes
        bins, x = _in_tile_chain(16, 64)
        flags = topology.order_flags(_t(bins).to(dev), _t(x).to(dev))
        want, want_sweeps = pt_ss.solve_blockwise_plain(flags)
        for cap in (pt_ss.BAND_MAX_PASSES, 8):
            monkeypatch.setattr(pt_ss, "BAND_MAX_PASSES", cap)
            got, got_sweeps = pt_ss.solve_blockwise(flags)
            assert torch.equal(got, want) and got_sweeps == want_sweeps
        return
    words = _t(_words(rng, 9).view(np.int32)).to(dev)
    if kernel == "rze_bitmap_u32":
        got = rze_kernel.rze_bitmap_u32(words)
        want = ref.rze_bitmap_ref(words)
    elif kernel == "bitshuffle_u32":
        got = (bitshuffle_kernel.bitshuffle_u32(words),)
        want = (ref.bitshuffle_ref(words),)
    else:
        got = (bitshuffle_kernel.bitunshuffle_u32(words),)
        want = (ref.bitunshuffle_ref(words),)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _ordered_batch(rng, dtype, b: int = 3, tile=(2, 4, 8)):
    """A haloed batch of ordered-space states and their all-pairs flags:
    values with SoS ties, each state seeded at the value's floor, and
    some cells outside the field (+inf values, the neutral ``iinfo.min``
    state)."""
    shape = (b,) + tuple(t + 2 for t in tile)
    x = (np.round(rng.standard_normal(shape) * 16) / 16).astype(dtype)
    x[rng.random(shape) < 0.1] = np.inf
    xt = _t(x)
    flags = torch.stack([topology.order_flags_all(xt[i]) for i in range(b)])
    flags = flags[:, 1:-1, 1:-1, 1:-1].contiguous()
    s = float_to_ordered(torch.where(torch.isinf(xt), 0.0, xt.floor()))
    s = torch.where(torch.isinf(xt), torch.iinfo(s.dtype).min, s)
    return s, flags


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_ordered_lanes_match_plain(rng, dev, dtype):
    for tile in ((4, 8, 16), (1, 16, 16), (1, 1, 4096)):
        s_h, flags = _ordered_batch(rng, dtype, b=5, tile=tile)
        LAUNCHES.clear()
        got, got_it = pt_ss.solve_tiles_blockwise(s_h.to(dev), flags.to(dev))
        want, want_it = pt_ss.solve_tiles_blockwise_plain(s_h.to(dev),
                                                          flags.to(dev))
        assert torch.equal(got, want) and torch.equal(got_it, want_it)
        key = ("solve_tiles_blockwise_64" if dtype == np.float64
               else "solve_tiles_blockwise")
        assert LAUNCHES[key] == 1


def test_cuda_ff32_kernels_match_plain(rng, dev):
    from repro_torch.kernels import fused_decode, quantize_kernel, ref

    for n in (1, 5, 4099, 1_000_003):
        x = (rng.standard_normal(n) * 10).astype(np.float32)
        x[: min(n, 3)] = [np.nan, np.inf, 3e9][: min(n, 3)]
        for off in (0, 1):  # 16-byte aligned and not
            xt = _t(x).to(dev)[off:]
            got = quantize_kernel.quantize_ff32(xt, 0.01)
            assert torch.equal(got, ref.quantize_ff32_ref(xt, 0.01))
            s = torch.randint(-3, 9, got.shape, dtype=torch.int32, device=dev)
            y = fused_decode.dequantize_ff32(got, s, 0.01)
            want = ref.dequantize_ff32_ref(got, s, 0.01)
            assert torch.equal(y.view(torch.int32), want.view(torch.int32))


# ------------------------------- kernels 3 and 3': every width and edge

WORDS = (2, 4, 8)
# (batch, tile elems): the 3-D plan tile, the 1-D and 2-D ones (4096
# cells, not a whole number of 16-bit chunks), an odd count, batch 1
SHAPES = [(4, 16384), (3, 4096), (2, 8192 + 100), (1, 16384)]
CASES = ["random", "zero chunk", "full bitmap", "extremes"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("subs_word", WORDS)
@pytest.mark.parametrize("bins_word", WORDS)
def test_cuda_decode_every_width_pair(rng, dev, bins_word, subs_word, dtype):
    for (batch, elems) in SHAPES:
        for case in CASES:
            args = [_t(a).to(dev) for a in
                    _streams(rng, batch, elems, bins_word, subs_word, case)]
            eps = _t(_eps(batch, dtype)).to(dev)
            LAUNCHES.clear()
            got = pt_fd.decode_tiles_fused(*args, eps, elems, dtype)
            assert LAUNCHES["decode_tiles_fused"] == 1
            want = pt_fd.decode_tiles_plain(*args, eps, elems, dtype)
            assert _bits_equal(got, want), (batch, elems, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bins_word", WORDS)
def test_cuda_decode_without_subbins_every_width(rng, dev, bins_word, dtype):
    for (batch, elems) in SHAPES:
        for case in CASES:
            bm, pk, _, _ = _streams(rng, batch, elems, bins_word, 2, case)
            args = [_t(bm).to(dev), _t(pk).to(dev), None, None]
            eps = _t(_eps(batch, dtype)).to(dev)
            LAUNCHES.clear()
            got = pt_fd.decode_tiles_fused(*args, eps, elems, dtype)
            assert LAUNCHES["decode_tiles_fused_nosub"] == 1
            want = pt_fd.decode_tiles_plain(*args, eps, elems, dtype)
            assert _bits_equal(got, want), (batch, elems, case)


# ------------------------------ kernels 2 and 4: every width and edge

@pytest.mark.parametrize("transform", ["delta", "raw", "zigzag"])
@pytest.mark.parametrize("word", WORDS)
def test_cuda_encode_every_width(rng, dev, word, transform):
    for batch, elems in SHAPES + [(3, 100)]:
        for case in ("random", "zero", "dense", "extremes"):
            if case == "extremes":
                ints = _extremes(batch, elems, word)
            elif case == "dense":  # every plane word nonzero, about
                info = np.iinfo(SIGNED[word])
                ints = rng.integers(info.min, info.max, (batch, elems),
                                    dtype=SIGNED[word], endpoint=True)
            else:
                ints = _ints(rng, batch, elems, word)
                if case == "zero":
                    ints[0] = 0
            x = _t(ints).to(dev)
            reset_launches()
            got = pt_fe.encode_ints_fused(x, CHUNK[word], transform)
            assert LAUNCHES["encode_ints_fused"] == 1
            assert TRANSFORM_LAUNCHES[f"encode_ints_fused_{transform}"] == 1
            want = pt_fe.encode_ints_plain(x, CHUNK[word], transform)
            for a, b in zip(got, want):
                assert _bits_equal(a, b), (batch, elems, case)


@pytest.mark.parametrize("word", [2, 4])
def test_cuda_encode_values_every_width(rng, dev, word):
    for batch, elems in SHAPES:
        x = _t(_values(rng, batch, elems, 30.0 if word == 2 else 3e4)).to(dev)
        eps = _t(rng.uniform(1e-3, 1.0, batch)).to(dev)
        store = torch.int16 if word == 2 else torch.int32
        LAUNCHES.clear()
        got = pt_fe.encode_values_fused(x, eps, CHUNK[word], torch.float32,
                                        store)
        assert LAUNCHES["encode_values_fused"] == 1
        want = pt_fe.encode_values_plain(x, eps, CHUNK[word], torch.float32,
                                         store)
        for a, b in zip(got, want):
            assert _bits_equal(a, b), (batch, elems)


def test_cuda_decode_refuses_streams_off_a_16_byte_boundary(rng, dev):
    """The decode copies stream rows 16 bytes at a time: a view that does
    not start on a 16-byte boundary raises instead of reading astray."""
    bm, pk, sbm, spk = _streams(rng, 2, 16384, 2, 2)
    flat = _t(np.concatenate([[0], pk.reshape(-1)]).astype(np.int16)).to(dev)
    shifted = flat[1:].view(pk.shape)  # 2 bytes past the allocation
    eps = _t(_eps(2, torch.float32)).to(dev)
    with pytest.raises(ValueError, match="16-byte"):
        pt_fd.decode_tiles_fused(_t(bm).to(dev), shifted, _t(sbm).to(dev),
                                 _t(spk).to(dev), eps, 16384, torch.float32)


@pytest.mark.parametrize("chunks", [1, 2, 3, 6104])
def test_cuda_bit4_transpose_adversarial_words(rng, dev, chunks):
    """Kernel 8 both ways on all-zero, all-one, single-bit, 0x80000000
    and alternating-byte words, and the round trip."""
    from repro_torch.kernels import bitshuffle_kernel, ref

    words = _t(bit4_words(rng, chunks).view(np.int32)).to(dev)
    LAUNCHES.clear()
    planes = bitshuffle_kernel.bitshuffle_u32(words)
    back = bitshuffle_kernel.bitunshuffle_u32(planes)
    assert LAUNCHES["bitshuffle_u32"] == 1 and LAUNCHES["bitunshuffle_u32"] == 1
    assert torch.equal(planes, ref.bitshuffle_ref(words))
    assert torch.equal(back, ref.bitunshuffle_ref(planes))
    assert torch.equal(back, words)


@pytest.mark.parametrize("word", [2, 4])
def test_cuda_encode_values_adversarial_cells(rng, dev, word):
    """Kernel 4 on the CPU model's adversarial cells, one tile per eps
    (1e-6 .. 1, and two bounds within 2x of the smallest normal), in
    tiles of 16384 cells and of an odd count (rows off a 16-byte
    boundary: the kernel's one-at-a-time loads); int16 stores wrap the
    bins of |q| up to 2^31."""
    epss = list(np.geomspace(1e-6, 1.0, 7)) + [2.0**-10, 1.5 * F32_TINY,
                                                2 * F32_TINY, 4 * F32_TINY]
    store = torch.int16 if word == 2 else torch.int32
    for elems in (16384, 8192 + 101):
        x = np.stack([np.resize(adversarial_cells(rng, e), elems)
                      for e in epss]).astype(np.float32)
        xt, et = _t(x).to(dev), _t(np.array(epss)).to(dev)
        LAUNCHES.clear()
        got = pt_fe.encode_values_fused(xt, et, CHUNK[word], torch.float32, store)
        assert LAUNCHES["encode_values_fused"] == 1
        want = pt_fe.encode_values_plain(xt, et, CHUNK[word], torch.float32,
                                         store)
        for a, b in zip(got, want):
            assert _bits_equal(a, b), elems


# ------------------------------------------------- the serving stack

def test_cuda_store_fixture_replay_equals_committed_bytes(dev, tmp_path):
    """``tests/data/make_fixtures.py``'s store calls on the card (the
    store's default device): the manifest and payloads equal the
    committed fixture byte for byte, and the reads its values."""
    from pathlib import Path

    from repro_torch.data.fields import make_field_sequence, make_scientific_field
    from repro_torch.engine.plan import CompressionPlan
    from repro_torch.store import LopcStore

    data = Path(__file__).resolve().parent / "data"
    store = LopcStore.create(tmp_path / "store",
                             plan=CompressionPlan(tile_shape=(8, 8, 8)))
    assert store.device.type == "cuda"
    LAUNCHES.clear()
    store.write("snap", make_scientific_field("front", (12, 11, 10),
                                              np.float32, seed=24), 1e-2)
    assert LAUNCHES["solve_tiles_blockwise"] > 0
    sframes = make_field_sequence("diffuse", "waves", (10, 9, 8), 3,
                                  np.float32, seed=25)
    store.write_chain("evolution", sframes[:2], 1e-1, mode="abs",
                      keyframe_interval=2)
    store.append_frame("evolution", sframes[2])
    LAUNCHES.clear()
    snap = store.read("snap")
    assert LAUNCHES["decode_tiles_fused"] > 0
    chain = store.read("evolution")
    store.close()
    for rel in ("manifest.json", "payload/snap.lopc",
                "payload/evolution.frames"):
        assert (tmp_path / "store" / rel).read_bytes() == \
            (data / "store" / rel).read_bytes(), rel
    want = np.load(data / "expected.npz")
    assert snap.tobytes() == want["store_snap"].tobytes()
    assert chain.tobytes() == want["store_chain"].tobytes()


def test_cuda_service_batch_of_four_concurrent_compresses(dev):
    """Four client threads submit at once; the batch coalesces and every
    container equals a direct compress on the card and on the CPU."""
    import threading

    from repro_torch import engine
    from repro_torch.service import CompressionService, ServiceConfig

    rng = np.random.default_rng(11)
    fields = [rng.standard_normal(s).astype(d) for s, d in
              (((40, 48, 64), np.float32), ((33, 20, 70), np.float64),
               ((16, 100, 64), np.float32), ((300, 200), np.float32))]
    svc = CompressionService(ServiceConfig(max_delay_ms=50.0),
                             autostart=False)
    futs = [None] * len(fields)

    def client(i):
        futs[i] = svc.submit_compress(fields[i], 1e-2)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(fields))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    LAUNCHES.clear()
    svc.start()
    try:
        blobs = [f.result(timeout=300) for f in futs]
        m = svc.metrics()
    finally:
        svc.stop()
    assert m.max_batch_occupancy == len(fields) and m.failed == 0
    assert LAUNCHES["solve_tiles_blockwise"] > 0
    assert LAUNCHES["encode_ints_fused"] > 0
    for x, b in zip(fields, blobs):
        assert b == engine.compress(x, 1e-2)
        assert b == engine.compress(x, 1e-2, device="cpu")


def test_cuda_traced_compress_spans_measure_device_time(dev, monkeypatch):
    """With tracing on, each stage records a CUDA event on the stream at
    each edge, so a stage's ``device_us`` holds the device work it queued
    while nothing waits for it.  The subbin encode (``exec.encode``) and
    the decode kernel (``exec.decode``) each queue a spin of known length
    behind their kernel; their ``device_us`` must be at least that long,
    while the host's ``dur_us`` of ``exec.encode`` stays below it (a stage
    that synchronized would hold the spin).  Every ``exec.*`` span of a
    compress and a decompress on the card carries a nonzero duration and a
    ``device_us``, nested inside its engine group's."""
    from repro_torch import engine, obs
    from repro_torch.engine import device

    x = np.random.default_rng(12).standard_normal((64, 96, 128)).astype(
        np.float32)
    engine.decompress(engine.compress(x, 1e-2))  # load the libraries
    cycles = 100_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    spin_us = start.elapsed_time(end) * 1e3
    spins = {"exec.encode": 0, "exec.decode": 0}

    def spun(fn, stage, when=lambda *a: True):
        def run(*a):
            out = fn(*a)
            if when(*a):
                torch.cuda._sleep(cycles)
                spins[stage] += 1
            return out
        return run

    # the subbin encode is the only "raw" one; the bins' is "delta"
    monkeypatch.setattr(device, "encode_tiles", spun(
        device.encode_tiles, "exec.encode", lambda ints, chunk, transform: transform == "raw"))
    for name in ("resident_decode_order", "resident_decode_plain"):
        monkeypatch.setattr(device, name, spun(getattr(device, name),
                                               "exec.decode"))
    obs.tracer().drain()
    obs.enable()
    try:
        blob = engine.compress(x, 1e-2)
        engine.decompress(blob)
        spans = obs.tracer().drain()
    finally:
        obs.disable()
    monkeypatch.undo()
    assert blob == engine.compress(x, 1e-2)
    by_id = {s.span_id: s for s in spans}
    stages = [s for s in spans if s.name.startswith("exec.")]
    assert {s.name for s in stages} >= {"exec.upload", "exec.solve",
                                        "exec.encode", "exec.download",
                                        "exec.stream_prep", "exec.decode"}
    for name, n in spins.items():
        assert n > 0, name
        held = sum(s.tags["device_us"] for s in stages if s.name == name)
        assert held >= 0.9 * n * spin_us, (name, held, n, spin_us)
    for s in stages:
        if s.name == "exec.encode":  # no sync imposed: the host moved on
            assert s.dur_us < spin_us, (s.dur_us, spin_us)
    for s in stages:
        assert s.dur_us > 0 and s.tags["device_us"] >= 0, s.name
        group = s
        while not group.name.startswith("engine."):
            group = by_id[group.parent_id]
        assert s.dur_us <= group.dur_us


def test_cuda_cluster_reads_equal_a_single_store(dev, tmp_path):
    """A 4-shard ``LocalCluster`` on the card (its default device): the
    router's write launches kernels 1 and 2, the workers' tile reads
    kernel 3; region and full reads equal a single store's on the card
    and on the CPU, also after the first tile's primary owner is
    killed."""
    from repro_torch.cluster import LocalCluster
    from repro_torch.engine.plan import CompressionPlan
    from repro_torch.store import LopcStore

    plan = CompressionPlan(tile_shape=(8, 8, 8), batch_tiles=4)
    x = np.random.default_rng(13).standard_normal((24, 20, 16)).astype(
        np.float32)
    x[1, 2, 3] = np.nan
    roi = (slice(3, 14), slice(2, 10), slice(5, 13))
    single = LopcStore.create(tmp_path / "single", plan=plan)
    cpu = LopcStore.create(tmp_path / "cpu", plan=plan, device="cpu")
    try:
        with LocalCluster(tmp_path / "cl", 4, plan=plan, n_replicas=2,
                          backoff=0.0) as cl:
            assert cl.router.device.type == "cuda"
            LAUNCHES.clear()
            cl.router.write("x", x, 1e-2)
            assert LAUNCHES["solve_tiles_blockwise"] > 0
            assert LAUNCHES["encode_ints_fused"] > 0
            LAUNCHES.clear()
            box = cl.router.read_roi("x", roi)
            assert LAUNCHES["decode_tiles_fused"] > 0
            for s in (single, cpu):
                s.write("x", x, 1e-2)
                assert box.tobytes() == s.read_roi("x", roi).tobytes()
            full = cl.router.read("x")
            assert full.tobytes() == cpu.read("x").tobytes()
            cl.kill(cl.router.map.owners("x", 0)[0])
            assert cl.router.read("x").tobytes() == full.tobytes()
            assert cl.router.metrics.snapshot()["failover_reads"] > 0
    finally:
        single.close()
        cpu.close()


def test_cuda_sharded_compress_over_nccl_equals_unsharded(dev, tmp_path):
    """``compress_fields_sharded`` over an NCCL group of world size 1 (the
    sharded solve's collectives on the card) and through a chain's
    ``put``: the unsharded bytes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import engine, temporal
    from repro_torch.data.fields import make_field_sequence, make_scientific_field
    from repro_torch.distributed import compress_fields_sharded, make_tile_put
    from repro_torch.engine.plan import CompressionPlan

    plan = CompressionPlan(tile_shape=(8, 8, 8), batch_tiles=12)
    fields = [make_scientific_field("turbulence", (40, 36, 30),
                                    np.dtype(np.float32), seed=1),
              make_scientific_field("gaussians", (24, 20, 16),
                                    np.dtype(np.float64), seed=5)]
    frames = make_field_sequence("advect", "gaussians", (16, 12, 10), 2,
                                 np.dtype(np.float32), seed=12)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "filestore"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        for kw in ({}, {"adaptive_eb": "tda"}, {"preserve_order": False}):
            assert compress_fields_sharded(fields, 1e-2, mesh, plan=plan,
                                           **kw) == \
                engine.compress_many(fields, 1e-2, plan=plan, **kw)
        assert temporal.compress_chains(
            [frames], 1e-2, plan=plan, put=make_tile_put(mesh)) == \
            temporal.compress_chains([frames], 1e-2, plan=plan)
    finally:
        dist.destroy_process_group()


def test_cuda_baselines_equal_the_cpu_path(dev):
    from repro_torch.codecs import baselines

    x = np.random.default_rng(3).standard_normal((30, 40, 50)).astype(np.float32)
    for name in ("pfpl_lite", "sz_lorenzo", "topoqz_lite"):
        got = getattr(baselines, name)(x, 1e-2)
        want = getattr(baselines, name)(x, 1e-2, device="cpu")
        assert got.blob == want.blob and got.decoded.tobytes() == \
            want.decoded.tobytes(), name
    reset_launches()
    blob = baselines.lossless_fp(x).blob
    assert blob == baselines.lossless_fp(x, device="cpu").blob
    assert baselines.lossless_fp_decode(blob).tobytes() == x.tobytes()
    assert LAUNCHES["bitshuffle_u32"] and LAUNCHES["bitunshuffle_u32"] \
        and LAUNCHES["rze_bitmap_u32"]


def test_cuda_checkpoint_files_equal_the_cpu_path(dev, tmp_path):
    from repro_torch.checkpoint import restore_tree, save_tree

    rng = np.random.default_rng(4)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)),
            "b": [torch.from_numpy(rng.standard_normal((2, 3, 16, 16))),
                  torch.tensor(7, dtype=torch.int32)],
            "bf": torch.from_numpy(rng.standard_normal((8, 8)).astype(
                np.float32)).to(torch.bfloat16)}
    for kw in ({"eb": 1e-3}, {}):
        for d in ("cuda", "cpu"):
            src = {k: (v.to(d) if isinstance(v, torch.Tensor) else
                       [t.to(d) for t in v]) for k, v in tree.items()}
            save_tree(src, tmp_path / f"{d}{len(kw)}", 0, device=d, **kw)
        files = [{p.name: p.read_bytes() for p in sorted(
            (tmp_path / f"{d}{len(kw)}" / "step_0").iterdir())}
            for d in ("cuda", "cpu")]
        assert files[0] == files[1]
        got, _ = restore_tree(tree, tmp_path / f"cuda{len(kw)}")
        want, _ = restore_tree(tree, tmp_path / f"cuda{len(kw)}", device="cpu")
        for a, b in zip(got["b"] + [got["w"], got["bf"]],
                        want["b"] + [want["w"], want["bf"]]):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _f32_stores(tree):
    if isinstance(tree, dict):
        return {k: _f32_stores(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32_stores(v) for v in tree]
    return tree.float() if isinstance(tree, torch.Tensor) \
        and tree.dtype == torch.bfloat16 else tree


def test_cuda_lm_serving_matches_the_cpu(dev):
    """The reduced qwen2.5-3b on the card against the same torch code on
    the CPU (f32 compute, TF32 off): prefill and 2 decode steps fed the
    CPU's greedy tokens.  With every cache store in f32, logits and
    caches within 1e-4 * R (R = max(1, max|cpu|)) and equal greedy
    tokens; as served, with the bf16 K/V cache within 3e-2 * R, with the
    int8 one logits within 1e-2 * R and codes at most one apart: those
    stores turn the matmuls' last-bit differences into whole steps."""
    from repro_torch.models import get_arch, reduced_for_smoke
    from repro_torch.models.convert import cache_to_reference
    from repro_torch.models.inputs import dummy_batch
    from repro_torch.models.model import Model

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for kv_quant, f32, rtol in ((False, True, 1e-4), (False, False, 3e-2),
                                    (True, False, 1e-2)):
            cfg = reduced_for_smoke(get_arch("qwen2.5-3b").config).scaled(
                dtype="float32", kv_quant=kv_quant)
            cpu = Model(cfg, device="cpu")
            gpu = Model(cfg, device=dev)
            gpu.load_state_dict(cpu.state_dict())
            batch = dummy_batch(cfg, 2, 20)
            steps = []
            for m in (cpu, gpu):
                if f32:
                    init = m.init_cache
                    m.init_cache = lambda b, n, init=init: _f32_stores(init(b, n))
                logits, caches = m.prefill(batch, 22)
                out = [(logits.cpu().numpy(), cache_to_reference(caches, cfg))]
                for t in range(2):
                    tok = steps[0][t][0].argmax(-1) if steps else \
                        logits.argmax(-1).cpu().numpy()
                    logits, caches = m.decode_step(torch.from_numpy(tok), caches)
                    out.append((logits.cpu().numpy(),
                                cache_to_reference(caches, cfg)))
                steps.append(out)
            for (lc, cc), (lg, cg) in zip(*steps):
                r = max(1.0, float(np.abs(lc).max()))
                assert float(np.abs(lc - lg).max()) <= rtol * r
                if f32:
                    assert np.array_equal(lc.argmax(-1), lg.argmax(-1))
                got = dict(_leaves(cg))
                for path, a in _leaves(cc):
                    b = got[path]
                    assert a.shape == b.shape and a.dtype == b.dtype, path
                    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
                    if a.dtype == np.int8:
                        assert d.max() <= 1, path
                    else:
                        assert d.max() <= rtol * max(1.0, float(np.abs(a).max())), path
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def train_step(model, cfg, batch):
    """One ``make_train_step`` from a fresh AdamW state: (metrics, grads
    and new weights on the CPU, the step's seconds with its gradients'
    download).  ``chip_smoke.py`` phase 2l (b) runs it too."""
    import time

    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step

    grads = {}

    def capture(g, opt):
        grads.update({k: v.detach().cpu() for k, v in g.items()})
        return g, opt

    opt = adamw.adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, grad_transform=capture, base_lr=1e-3,
                           total_steps=20)
    t0 = time.perf_counter()
    _, _, met = step(model, opt, batch)
    met = {k: float(v) for k, v in met.items()}
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (met, grads,
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            seconds)


def first_step_tol(g, lr: float, rtol: float, eps: float = 1e-8):
    """Per element, how far two devices' first AdamW steps may part when
    their (clipped) gradients ``g`` agree within ``rtol * max|g|``: the
    step is ``lr * g / (|g| + eps)``, whose slope in ``g`` is ``eps /
    (|g| + eps)**2``; a gradient within that tolerance of zero has its
    sign set by the two devices' roundings and may step either way (2
    lr)."""
    g = g.abs()
    delta = 2 * rtol * float(g.max())  # the gradients' and the clip's
    near = torch.clamp(g - delta, min=0.0)
    return torch.where(g <= delta, 2 * lr, lr * delta * eps / (near + eps) ** 2)


def test_cuda_lm_train_step_matches_the_cpu(dev):
    """One train step of the reduced qwen2.5-3b on the card against the
    same torch code on the CPU, from the same weights and batch (TF32
    off): in f32 compute the loss, grad norm, every gradient leaf and the
    updated weights within 1e-4 of each leaf's largest CPU value; in bf16
    compute within 3e-2.  A weight's step may also part by the slope of
    AdamW's first step ``lr * g / (|g| + eps)`` times the gradients'
    tolerance, and by 2 lr where that tolerance sets the gradient's
    sign (the K bias's gradient, which the softmax nearly cancels)."""
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.models import get_arch, reduced_for_smoke
    from repro_torch.models.model import Model

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype, rtol in (("float32", 1e-4), ("bfloat16", 3e-2)):
            cfg = reduced_for_smoke(get_arch("qwen2.5-3b").config).scaled(
                dtype=dtype)
            cpu = Model(cfg, device="cpu")
            gpu = Model(cfg, device=dev)
            gpu.load_state_dict(cpu.state_dict())
            batch = SyntheticLMStream(cfg, 2, 32).batch_at(0)
            mc, gc, pc, _ = train_step(cpu, cfg, batch)
            mg, gg, pg, _ = train_step(gpu, cfg, batch)
            for k, v in mc.items():
                assert abs(mg[k] - v) <= rtol * max(1.0, abs(v)), k
            for k, g in gc.items():
                assert float((g - gg[k]).abs().max()) <= \
                    rtol * float(g.abs().max()), k
            scale = min(1.0, 1.0 / max(mc["grad_norm"], 1e-9))
            for k, p in pc.items():
                d = (p - pg[k]).double().abs()
                tol = first_step_tol(gc[k] * scale, mc["lr"], rtol)
                assert bool((d <= tol + rtol * float(p.abs().max())).all()), k
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_cuda_trainer_checkpoints_launch_kernels_8_and_9(dev, tmp_path):
    """The ``Trainer``'s lossless checkpoints on the card: every save
    launches the BIT_4 transpose and the RZE bitmap on each lossless
    leaf, the restore the transpose's inverse, and the restored tree
    equals the saved one bit for bit."""
    from repro_torch.checkpoint.manager import restore_tree
    from repro_torch.models import get_arch, reduced_for_smoke
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = reduced_for_smoke(get_arch("qwen2.5-3b").config)
    tc = TrainerConfig(total_steps=2, ckpt_every=1, ckpt_dir=str(tmp_path),
                       global_batch=2, seq_len=16)
    reset_launches()
    t = Trainer(cfg, tc, device=dev)
    model, opt = t.run(0)
    lossless = sum(leaf["codec"] == "lopc-lossless"
                   for leaf in t.ckpt.last_manifest["leaves"])
    saves = dict(LAUNCHES)
    assert lossless > 0
    assert saves.get("bitshuffle_u32", 0) == 2 * lossless
    assert saves.get("rze_bitmap_u32", 0) == 2 * lossless
    reset_launches()
    want = t.checkpoint_tree(model, opt)
    got, step = restore_tree(want, tmp_path, device=dev)
    assert step == 1 and dict(LAUNCHES).get("bitunshuffle_u32", 0) == lossless

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    for a, b in zip(leaves(want), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_cuda_moe_ep_on_two_gloo_ranks_equals_world_1(dev, tmp_path):
    """``chip_smoke.py`` phase 2m (b)'s check at a small width: mixtral's
    MoE block (8 experts, d 64 x d_ff 128) in EP mode on 2 gloo ranks
    (subprocesses) on the card, 4 experts a rank, the token slots through
    two ``all_to_all``s staged through the host; with f32 compute and 1 x
    8 tokens no expert overflows, so the ranks' outputs equal the world-1
    ``local_moe`` within 1e-5 of its max|out|."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_moe_ep_rank.py"), str(r), "2",
         str(tmp_path / "store"), str(outs[r]), "64", "128"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    ranks = [torch.load(o) for o in outs]
    ref, ref_aux = ranks[0]["world1"]
    got = torch.cat([r["f32"]["out"] for r in ranks], dim=1)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    for r in ranks:
        assert abs(r["f32"]["aux"] - ref_aux) <= 1e-6 * abs(ref_aux)
        assert r["f32"]["experts_here"] == (4, 64, 128)
        # two exchanges a call, staged through the host, and the aux's sum
        assert r["f32"]["collectives"]["all_to_all"] == 2
        assert torch.isfinite(r["bf16"]["out"]).all()
