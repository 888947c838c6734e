"""Each kernel's plain PyTorch version against its Pallas kernel run in
interpret mode (as the JAX tests run it on the CPU), bit for bit; and,
where a CUDA device exists, each CUDA kernel against its plain version.

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


def test_plain_path_counts_no_launches(rng):
    LAUNCHES.clear()
    sub_h, flags = _solve_inputs(rng, 2, (2, 2, 4))
    pt_ss.solve_tiles_blockwise(_t(sub_h), _t(flags.view(np.int32)))
    pt_fe.encode_ints_fused(_t(_ints(rng, 2, 64, 4)), 4096, "delta")
    assert sum(LAUNCHES.values()) == 0


# ---------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["solve", "encode", "decode"])
def test_cuda_kernel_matches_plain(rng, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py compares them there)")
    dev = torch.device("cuda")
    if kernel == "solve":
        sub_h, flags = _solve_inputs(rng, 64, (16, 16, 64))
        args = (_t(sub_h), _t(flags.view(np.int32)))
        plain = pt_ss.solve_tiles_blockwise_plain(*(a.to(dev) for a in args))
        got = pt_ss.solve_tiles_blockwise(*(a.to(dev) for a in args))
    elif kernel == "encode":
        ints = _t(_ints(rng, 64, 16384, 2)).to(dev)
        plain = pt_fe.encode_ints_plain(ints, 8192, "delta")
        got = pt_fe.encode_ints_fused(ints, 8192, "delta")
    else:
        bm, pk, sbm, spk = _streams(rng, 8, 16384, 2, 2)
        args = [_t(a.view(np.int16)).to(dev) for a in (bm, pk, sbm, spk)]
        eps = torch.full((8,), 1e-3, dtype=torch.float64, device=dev)
        plain = (pt_fd.decode_tiles_plain(*args, eps, 16384, torch.float32),)
        got = (pt_fd.decode_tiles_fused(*args, eps, 16384, torch.float32),)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
