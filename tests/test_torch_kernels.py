"""Each kernel's plain PyTorch version against its Pallas kernel run in
interpret mode (as the JAX tests run it on the CPU), bit for bit.  Each
CUDA kernel against its plain version, on the card:
tests/test_torch_cuda.py.

Tiles are small (4x4x8) so interpret mode stays fast.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as ref_topo
from repro.engine import device as ref_device
from repro.kernels import fused_decode as ref_fd
from repro.kernels import fused_encode as ref_fe
from repro.kernels import subbin_sweep as ref_ss
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import fused_decode as pt_fd
from repro_torch.kernels import fused_encode as pt_fe
from repro_torch.kernels import subbin_sweep as pt_ss

CHUNK = {2: 8192, 4: 4096, 8: 2048}
SIGNED = {2: np.int16, 4: np.int32, 8: np.int64}
UNSIGNED = {2: np.uint16, 4: np.uint32, 8: np.uint64}
TORCH_SIGNED = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _solve_inputs(rng, batch: int, tile, random_flags: bool = False):
    """A haloed subbin batch and order flags of tied random tiles."""
    h = tuple(t + 2 for t in tile)
    x = np.round(rng.standard_normal((batch,) + h) * 1.5) / 2
    bins = np.round(x).astype(np.int32)
    flags = np.stack([np.asarray(ref_topo.order_flags(jnp.asarray(b),
                                                      jnp.asarray(v)))
                      for b, v in zip(bins, x)])[:, 1:-1, 1:-1, 1:-1]
    if random_flags:  # cyclic constraints: every tile runs to the cap
        flags = rng.integers(0, 2**14, flags.shape).astype(np.uint32)
    sub_h = rng.integers(0, 4, (batch,) + h).astype(np.int32)
    return sub_h, np.ascontiguousarray(flags).astype(np.uint32)


@pytest.mark.parametrize("tile,random_flags", [((4, 4, 8), False),
                                               ((1, 6, 6), False),
                                               ((1, 1, 40), False),
                                               ((2, 3, 4), True)])
def test_solve_plain_matches_pallas_interiors_and_iters(rng, tile, random_flags):
    sub_h, flags = _solve_inputs(rng, 5, tile, random_flags)
    want, want_it = ref_ss.solve_tiles_blockwise(
        jnp.asarray(sub_h), jnp.asarray(flags), interpret=True)
    got, got_it = pt_ss.solve_tiles_blockwise(_t(sub_h), _t(flags.view(np.int32)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_it.numpy(), np.asarray(want_it))
    assert got_it.dtype == torch.int32
    if random_flags:  # every tile hit the tile_elems + 2 sweep cap
        assert (np.asarray(want_it) == int(np.prod(tile)) + 2).all()
    else:
        assert np.asarray(want_it).max() > 1


def _ints(rng, batch, elems, word):
    dt = SIGNED[word]
    hi = min(np.iinfo(dt).max, 2**40)
    base = np.cumsum(rng.integers(-3, 4, (batch, elems)), axis=1)
    vals = (base + rng.integers(-hi // 2, hi // 2, (batch, 1))).astype(dt)
    vals[0, : elems // 3] = 0            # zero runs -> sparse bitmaps
    vals[-1, 1::7] = np.iinfo(dt).min    # wrapping deltas
    return vals


@pytest.mark.parametrize("word,transform,elems", [
    (2, "delta", 128), (4, "delta", 128), (8, "delta", 128),
    (2, "raw", 128), (4, "raw", 128),
    (2, "delta", 8192 + 100), (4, "raw", 4096 + 37), (8, "delta", 2048 + 5),
    (2, "zigzag", 8192 + 100), (4, "zigzag", 128), (8, "zigzag", 128),
])
def test_encode_plain_matches_pallas(rng, word, transform, elems):
    ints = _ints(rng, 3, elems, word)
    if transform == "raw":
        ints = np.abs(ints % 1000).astype(ints.dtype)
    want = ref_fe.encode_ints_fused(jnp.asarray(ints), CHUNK[word], transform,
                                    interpret=True)
    got = pt_fe.encode_ints_fused(_t(ints), CHUNK[word], transform)
    u = UNSIGNED[word]
    assert np.array_equal(got[0].numpy().view(u), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(u), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def _streams(rng, batch, tile_elems, bins_word, subs_word):
    """Encoded (bins delta, subs raw) streams from the reference encoder."""
    bins = _ints(rng, batch, tile_elems, bins_word) // 4
    subs = rng.integers(0, 9, (batch, tile_elems)).astype(SIGNED[subs_word])
    bm, pk, _ = ref_device.encode_tiles(jnp.asarray(bins), CHUNK[bins_word], "delta")
    sbm, spk, _ = ref_device.encode_tiles(jnp.asarray(subs), CHUNK[subs_word], "raw")
    # front-pack each row's nonzero words, as the container stores them
    def pack(rows):
        rows = np.asarray(rows)
        out = np.zeros_like(rows)
        for r in range(rows.shape[0]):
            nz = rows[r][rows[r] != 0]
            out[r, : nz.size] = nz
        return out
    return np.asarray(bm), pack(pk), np.asarray(sbm), pack(spk)


@pytest.mark.parametrize("bins_word,subs_word,tile_elems", [
    (2, 2, 128), (4, 2, 128), (2, 4, 128), (4, 4, 4096 + 64)])
def test_decode_plain_matches_pallas_f32(rng, bins_word, subs_word, tile_elems):
    batch = 4
    bm, pk, sbm, spk = _streams(rng, batch, tile_elems, bins_word, subs_word)
    eps = np.array([1e-3, 2.5e-2, 0.7, 3.0])
    want = ref_fd.decode_tiles_fused(
        jnp.asarray(bm), jnp.asarray(pk), jnp.asarray(sbm), jnp.asarray(spk),
        jnp.asarray(eps), tile_elems, np.float32, interpret=True)
    sb, ss = SIGNED[bins_word], SIGNED[subs_word]
    got = pt_fd.decode_tiles_fused(_t(bm.view(sb)), _t(pk.view(sb)),
                                   _t(sbm.view(ss)), _t(spk.view(ss)),
                                   _t(eps), tile_elems, torch.float32)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("bins_word,subs_word", [(8, 2), (4, 4), (2, 8)])
def test_decode_plain_matches_staged_reference_f64(rng, bins_word, subs_word):
    """The reference decodes f64 through its staged chain; the plain
    version covers f64 with the same function."""
    batch, tile_elems = 3, 128
    bm, pk, sbm, spk = _streams(rng, batch, tile_elems, bins_word, subs_word)
    eps = np.array([1e-9, 3e-4, 2.0])
    want = ref_device.resident_decode_order(
        jnp.asarray(bm), jnp.asarray(pk), jnp.asarray(sbm), jnp.asarray(spk),
        jnp.asarray(eps), tile_elems, np.float64)
    sb, ss = SIGNED[bins_word], SIGNED[subs_word]
    got = pt_fd.decode_tiles_fused(_t(bm.view(sb)), _t(pk.view(sb)),
                                   _t(sbm.view(ss)), _t(spk.view(ss)),
                                   _t(eps), tile_elems, torch.float64)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def _values(rng, batch, elems, scale):
    """f32 interiors with NaN pad cells, one NaN pad row, non-finite
    cells, signed zeros, denormals and exact half-bin ties."""
    x = (rng.standard_normal((batch, elems)) * scale).astype(np.float32)
    x[:, elems - 37:] = np.nan          # tile pad
    x[-1] = np.nan                      # a pad tile
    x[0, 3], x[0, 4], x[0, 5] = np.inf, -np.inf, -0.0
    x[0, 6:40] = np.float32(1e-41) * np.arange(34)
    return x


@pytest.mark.parametrize("word,batch,elems,block_tiles", [
    (2, 3, 128, 2), (4, 3, 128, 2), (2, 5, 8192 + 100, 3), (4, 4, 4096 + 9, 1)])
def test_encode_values_plain_matches_pallas(rng, word, batch, elems, block_tiles):
    """``encode_values_plain`` against the Pallas kernel in interpret
    mode, at odd batch sizes (the kernel pads them with NaN rows)."""
    x = _values(rng, batch, elems, 30.0 if word == 2 else 3e4)
    eps = rng.uniform(1e-3, 1.0, batch)
    eps[1] = 0.25                       # exact ties: x / eps = k + 0.5
    x[1, :64] = ((np.arange(64) - 32) + 0.5).astype(np.float32) * 0.25
    want = ref_fe.encode_values_fused(jnp.asarray(x), jnp.asarray(eps),
                                      CHUNK[word], np.float32, SIGNED[word],
                                      interpret=True, block_tiles=block_tiles)
    got = pt_fe.encode_values_fused(_t(x), _t(eps), CHUNK[word],
                                    torch.float32, TORCH_SIGNED[word])
    u = UNSIGNED[word]
    assert np.array_equal(got[0].numpy().view(u), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(u), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("bins_word,dtype", [(2, np.float32), (4, np.float32),
                                             (2, np.float64), (8, np.float64)])
def test_decode_no_subbins_matches_reference_plain_decode(rng, bins_word, dtype):
    """The no-subbin decode against ``resident_decode_plain``, the
    reference's plain-container chain."""
    batch, tile_elems = 3, 2048 * 2 + 40
    bm, pk, _, _ = _streams(rng, batch, tile_elems, bins_word, 2)
    eps = np.array([1e-9, 3e-4, 2.0]) if dtype == np.float64 else \
        np.array([1e-3, 2.5e-2, 0.7])
    want = ref_device.resident_decode_plain(
        jnp.asarray(bm), jnp.asarray(pk), jnp.asarray(eps), tile_elems,
        np.dtype(dtype))
    sb = SIGNED[bins_word]
    got = pt_fd.decode_tiles_fused(_t(bm.view(sb)), _t(pk.view(sb)), None,
                                   None, _t(eps), tile_elems,
                                   torch.float32 if dtype == np.float32
                                   else torch.float64)
    assert got.numpy().dtype == np.dtype(dtype)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_plain_path_counts_no_launches(rng):
    LAUNCHES.clear()
    sub_h, flags = _solve_inputs(rng, 2, (2, 2, 4))
    pt_ss.solve_tiles_blockwise(_t(sub_h), _t(flags.view(np.int32)))
    pt_fe.encode_ints_fused(_t(_ints(rng, 2, 64, 4)), 4096, "delta")
    pt_fe.encode_values_fused(_t(_values(rng, 2, 64, 1.0)), _t(np.ones(2)),
                              8192, torch.float32, torch.int16)
    assert sum(LAUNCHES.values()) == 0
