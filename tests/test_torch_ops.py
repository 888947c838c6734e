"""The whole-field kernels, the subbin schedules and the v1 pipeline of
the port against the JAX reference, on the CPU: the plain versions of
the band solve, the BIT_4 transpose and the RZE bitmap against the
reference's Pallas kernels in interpret mode (through
``repro.kernels.ops``), bit for bit, with equal sweep counts.  Each CUDA
kernel against its plain version, on the card: tests/test_torch_cuda.py.

Inputs are made from seeds with numpy and handed to both packages.
Every comparison is exact.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import subbin as ref_subbin
from repro.core import topology as ref_topology
from repro.core.quantize import quantize as ref_quantize
from repro.data.fields import make_scientific_field as ref_field
from repro.kernels import ops as ref_ops
from repro.kernels import subbin_sweep as ref_ss
from repro_torch.codecs import pipeline as pt_pipeline
from repro_torch.core import subbin as pt_subbin
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import subbin_sweep as pt_ss

ref_pipeline = importlib.import_module("repro.codecs.pipeline")

KERNEL_SHAPES = [(40,), (17, 23), (9, 11, 13), (64, 8, 4)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _bins_values(x: np.ndarray, eps_abs: float):
    """The reference's bins of ``x`` as numpy, beside ``x``."""
    return np.asarray(ref_quantize(jnp.asarray(x), eps_abs)), x


def _long_chain():
    """128x4x4 descending in x: one chain across the whole X extent."""
    x = -np.cumsum(np.full((128, 4, 4), 1e-9), axis=0)
    return _bins_values(x, 1.0)


# ---------------------------------------------------------- kernel 5

@pytest.mark.parametrize("shape", KERNEL_SHAPES + ["long chain"])
def test_band_solve_matches_pallas_subbins_and_sweeps(rng, shape):
    if shape == "long chain":
        bins, x = _long_chain()
    else:
        bins, x = _bins_values(rng.uniform(-1, 1, shape), 0.5)
    want, want_sweeps = ref_ops.solve_subbins_blockwise(jnp.asarray(bins),
                                                        jnp.asarray(x))
    got, got_sweeps = pt_ops.solve_subbins_blockwise(_t(bins), _t(x))
    assert got.dtype == torch.int64 and got.shape == bins.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got_sweeps == int(want_sweeps)
    jac, jac_sweeps = pt_subbin.solve_subbins(_t(bins), _t(x), method="jacobi")
    assert torch.equal(jac, got)
    if shape == "long chain":  # the point of the bands
        assert got_sweeps < jac_sweeps / 3, (got_sweeps, jac_sweeps)


def test_band_solve_int32_bins_keep_int32_subbins(rng):
    x = rng.uniform(-1, 1, (24, 6, 5)).astype(np.float32)
    bins, _ = _bins_values(x, 0.5)
    want, want_sweeps = ref_ops.solve_subbins_blockwise(jnp.asarray(bins),
                                                        jnp.asarray(x))
    got, got_sweeps = pt_ops.solve_subbins_blockwise(_t(bins), _t(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got_sweeps == int(want_sweeps)


def _serpentine(x: int, y: int, z: int):
    """(x, y, z) field constant in X whose values fall along a corridor
    that winds through the whole Y x Z plane: Z forward on rows 0, 4,
    8, ..., backward on rows 2, 6, ..., joined by one cell of the odd row
    between them at the turn, all inside one bin; the other cells of the
    odd rows are a wall in another bin.  So one chain runs through every
    corridor cell of every band's plane."""
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
    boustrophedon through all of its 8 x ty x tz cells inside one bin
    (Z forward and backward by turns, Y likewise in each X-row), the
    other bands a wall in another bin: one chain of 8 * ty * tz - 1 hops
    inside one tile of an inner band, whose X halo never moves."""
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
    """64x4x4 rising in X inside one bin, with X-row 0 falling in Z: the
    subbins of row 0 (Z - 1 - z) are carried up X one band per global
    sweep (a rise in X needs no raise, so each band is still until the
    front reaches it)."""
    x = np.arange(64, dtype=np.float64)[:, None, None] * 1e-9 + np.zeros((64, 4, 4))
    x[0] = -np.arange(4, dtype=np.float64)[None, :] * 1e-12
    return _bins_values(x, 1.0)


def _band_schedule(flags: np.ndarray, ty: int, tz: int, rng,
                   max_passes: int | None = None):
    """numpy emulation of the band kernel's launch schedule: in every
    launch the 8 x ``ty`` x ``tz`` tiles of every band are visited in a
    random order (standing in for the CTAs of a launch, which run in no
    order), and each one the launch selects is relaxed to convergence, or
    for at most ``max_passes`` passes, with its Y/Z halo read from the
    current state (zero fill outside the plane) and its X halo from the
    band rows 0 and 7 taken at the sweep's start.  A solve's first launch
    selects every tile, a later sweep's first launch the tiles beside (in
    Y/Z, in a neighbour band) a tile that moved in the sweep before, a
    sweep's later launches the tiles beside (in Y/Z, in the same band) a
    tile that moved in the launch before and the tiles the pass cap
    stopped in it; a tile stamps 2 x the launch at which it moved, plus 1
    if the cap stopped it.  Launches repeat until one changes nothing;
    sweeps until one changes nothing.  Returns (subbins, global sweeps,
    launches, tile relaxations)."""
    band = pt_ss.BAND
    x, y, z = flags.shape
    xp = -(-x // band) * band
    g = xp // band
    yp, zp = -(-y // ty) * ty, -(-z // tz) * tz
    f = np.zeros((xp, yp, zp), np.int64)
    f[:x, :y, :z] = flags
    offs = ref_topology.offsets(3)
    ties = ref_topology.tie_breaker(3)
    need = [((f >> k) & 1).astype(bool) for k in range(len(offs))]
    sub = np.zeros((xp, yp + 2, zp + 2), np.int64)  # zero fill in Y, Z
    inner = (slice(None), slice(1, yp + 1), slice(1, zp + 1))
    ny, nz = yp // ty, zp // tz
    tiles = [(b, j, k) for b in range(g) for j in range(ny) for k in range(nz)]
    stamp = np.full((g, ny, nz), -1)
    sweeps = launch = relaxed = 0
    since = -1
    while True:
        lo = sub[band - 1 :: band].copy()  # row 7 of every band
        hi = sub[::band].copy()            # row 0 of every band
        first = launch
        sweep_moved = False
        while True:
            moved = False
            for t in rng.permutation(len(tiles)):
                b, j, k = tiles[t]
                near = (slice(max(j - 1, 0), j + 2), slice(max(k - 1, 0), k + 2))
                if launch > first:  # beside a tile that moved last launch
                    st = stamp[b][near] >> 1
                    st[j - near[0].start, k - near[1].start] = -1
                    capped = stamp[b, j, k] == 2 * (launch - 1) + 1
                    if not ((st == launch - 1).any() or capped):
                        continue
                elif since >= 0:  # beside a tile whose rows 0 and 7 moved
                    bands_near = [max(b - 1, 0), min(b + 1, g - 1)]
                    st = stamp[bands_near][:, near[0], near[1]] >> 1
                    if not (st >= since).any():
                        continue
                relaxed += 1
                rows = slice(b * band, (b + 1) * band)
                h = np.concatenate([lo[max(b - 1, 0)][None], sub[rows],
                                    hi[min(b + 1, g - 1)][None]])
                h = h[:, j * ty : (j + 1) * ty + 2, k * tz : (k + 1) * tz + 2].copy()
                fl = [n[rows, j * ty : (j + 1) * ty, k * tz : (k + 1) * tz]
                      for n in need]
                start = h[1:-1, 1:-1, 1:-1].copy()
                passes, capped = 0, True
                while max_passes is None or passes < max_passes:
                    passes += 1
                    cur = h[1:-1, 1:-1, 1:-1]
                    new = cur.copy()
                    for n, (ox, oy, oz), tie in zip(fl, offs, ties):
                        nb = h[1 + ox : 1 + ox + band, 1 + oy : 1 + oy + ty,
                               1 + oz : 1 + oz + tz]
                        new = np.where(n, np.maximum(new, nb + int(tie)), new)
                    if np.array_equal(new, cur):
                        capped = False
                        break
                    h[1:-1, 1:-1, 1:-1] = new
                if not np.array_equal(h[1:-1, 1:-1, 1:-1], start):
                    moved = True
                    stamp[b, j, k] = 2 * launch + int(capped)
                    sub[rows, j * ty + 1 : (j + 1) * ty + 1,
                        k * tz + 1 : (k + 1) * tz + 1] = h[1:-1, 1:-1, 1:-1]
            launch += 1
            sweep_moved |= moved
            if not moved:
                break
        sweeps += 1
        since = first
        if not sweep_moved:
            break
    return sub[inner][:x, :y, :z], sweeps, launch, relaxed


@pytest.mark.parametrize("case", ["random", "serpentine", "front",
                                  "in-tile chain, pass cap"])
def test_band_kernel_schedule_matches_pallas(rng, case):
    """The band kernel's schedule (tiles relaxed to convergence in any
    order, Y/Z halo from the current state, X halo from the sweep start,
    only the tiles whose input may have changed, launches until one
    changes nothing) reaches the reference's subbins in the reference's
    number of global sweeps.  Y and Z are not
    multiples of the tile; the serpentine's one chain crosses every tile
    of its band many times; the front reaches one band more each sweep,
    so a sweep's first launch must take the bands beside a band that
    moved in the sweep before, though they did not move then.  The
    in-tile chain is longer than the pass cap inside one tile of an inner
    band that no neighbour tile moves: the launches after the cap must
    take that tile up again on their own."""
    max_passes = None
    if case == "random":
        bins, x = _bins_values(rng.uniform(-1, 1, (19, 11, 13)), 0.5)
    elif case == "serpentine":
        bins, x = _serpentine(8, 11, 13)
    elif case == "front":
        bins, x = _front()
    else:
        bins, x = _in_tile_chain(4, 8)
        max_passes = 16
    flags = np.asarray(ref_topology.order_flags(jnp.asarray(bins),
                                                jnp.asarray(x)))
    want, want_sweeps = ref_ss.solve_blockwise(jnp.asarray(flags),
                                               interpret=True)
    got, sweeps, launches, relaxed = _band_schedule(flags.astype(np.int64),
                                                    4, 8, rng, max_passes)
    assert np.array_equal(got, np.asarray(want))
    assert sweeps == int(want_sweeps)
    n_tiles = -(-flags.shape[0] // 8) * -(-flags.shape[1] // 4) * -(-flags.shape[2] // 8)
    assert relaxed < launches * n_tiles  # launches skip settled tiles
    if case == "serpentine":  # the chain is far longer than a tile
        assert int(np.asarray(want).max()) > 40 and launches > sweeps
    if max_passes:  # 255 hops: the cap stops the tile again and again
        assert launches > 255 // max_passes
    plain, plain_sweeps = pt_ss.solve_blockwise_plain(_t(flags.view(np.int32)))
    assert np.array_equal(plain.numpy(), got) and plain_sweeps == sweeps


# ------------------------------------------------------ kernels 8, 9

def _words(rng, c: int, pattern: str) -> np.ndarray:
    if pattern == "zeros":
        return np.zeros((c, 4096), np.uint32)
    if pattern == "ones":
        return np.full((c, 4096), 0xFFFFFFFF, np.uint32)
    w = rng.integers(0, 2**32, (c, 4096), dtype=np.uint64).astype(np.uint32)
    w[rng.random((c, 4096)) < 0.4] = 0
    w[0, :700] = 0  # a dead run: all-zero bitmap words
    return w


@pytest.mark.parametrize("c", [1, 3, 5])
@pytest.mark.parametrize("pattern", ["zeros", "ones", "random"])
def test_bitshuffle_and_rze_plain_match_pallas(rng, c, pattern):
    words = _words(rng, c, pattern)
    pt = _t(words.view(np.int32))
    shuffled = pt_ops.bitshuffle_u32(pt)
    want = np.asarray(ref_ops.bitshuffle_u32(jnp.asarray(words)))
    assert shuffled.numpy().view(np.uint32).tobytes() == want.tobytes()
    back = pt_ops.bitunshuffle_u32(shuffled)
    want_back = np.asarray(ref_ops.bitunshuffle_u32(jnp.asarray(want)))
    assert np.array_equal(back.numpy(), pt.numpy())
    assert np.array_equal(want_back, words)
    bitmap, counts = pt_ops.rze_bitmap_u32(pt)
    want_bm, want_counts = ref_ops.rze_bitmap_u32(jnp.asarray(words))
    assert bitmap.shape == (c, 128) and counts.dtype == torch.int32
    assert bitmap.numpy().view(np.uint32).tobytes() == np.asarray(want_bm).tobytes()
    assert np.array_equal(counts.numpy(), np.asarray(want_counts))


def test_plain_versions_count_no_launches(rng):
    LAUNCHES.clear()
    pt = _t(_words(rng, 2, "random").view(np.int32))
    pt_ops.bitunshuffle_u32(pt_ops.bitshuffle_u32(pt))
    pt_ops.rze_bitmap_u32(pt)
    bins, x = _bins_values(rng.uniform(-1, 1, (16, 4, 4)), 0.5)
    pt_ops.solve_subbins_blockwise(_t(bins), _t(x))
    assert sum(LAUNCHES.values()) == 0


# ------------------------------------------------------- core.subbin

@pytest.mark.parametrize("shape", [(13, 11, 9), (40, 28), (500,)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_and_frontier_match_reference(shape, dtype):
    x = ref_field("gaussians", shape, np.dtype(dtype), seed=5)
    bins, _ = _bins_values(x, 0.05 * float(x.max() - x.min()))
    for method in ("jacobi", "frontier"):
        want, want_sweeps = ref_subbin.solve_subbins(jnp.asarray(bins),
                                                     jnp.asarray(x), method=method)
        got, got_sweeps = pt_subbin.solve_subbins(_t(bins), _t(x), method=method)
        assert got.numpy().dtype == np.asarray(want).dtype
        assert np.array_equal(got.numpy(), np.asarray(want)), method
        assert got_sweeps == int(want_sweeps), method
        assert got_sweeps > 2  # the chains are real
    # auto on a CPU tensor is jacobi, as in the reference
    auto, auto_sweeps = pt_subbin.solve_subbins(_t(bins), _t(x))
    want, want_sweeps = ref_subbin.solve_subbins(jnp.asarray(bins), jnp.asarray(x))
    assert np.array_equal(auto.numpy(), np.asarray(want))
    assert auto_sweeps == int(want_sweeps)
    # verify_no_violation agrees on the solution and on all-zero subbins
    for sub in (auto, torch.zeros_like(auto)):
        assert pt_subbin.verify_no_violation(_t(bins), _t(x), sub) == bool(
            ref_subbin.verify_no_violation(jnp.asarray(bins), jnp.asarray(x),
                                           jnp.asarray(sub.numpy())))
    assert not pt_subbin.verify_no_violation(_t(bins), _t(x), torch.zeros_like(auto))


def test_encode_field_matches_reference(rng):
    x = ref_field("waves", (12, 10, 8), np.dtype("float64"), seed=2)
    want = ref_subbin.encode_field(jnp.asarray(x), 0.05)
    got = pt_subbin.encode_field(_t(x), 0.05)
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert got[2] == int(want[2])


def test_unknown_solver_raises(rng):
    bins, x = _bins_values(rng.uniform(-1, 1, (6, 5)), 0.5)
    with pytest.raises(ValueError, match="unknown solver"):
        pt_subbin.solve_subbins(_t(bins), _t(x), method="nope")


# --------------------------------------------------- codecs.pipeline

@pytest.mark.parametrize("dtype,n", [(np.int32, 10000), (np.int32, 4096),
                                     (np.int64, 5000), (np.int64, 77)])
def test_pipeline_sections_match_reference(rng, dtype, n):
    ints = rng.integers(-300, 300, n).astype(dtype)
    ints[: n // 3] = 7  # a flat run: zero deltas, dead planes
    subs = rng.integers(0, 3, n).astype(dtype)
    subs[n // 2 :] = 0
    shape = (n,) if n % 2 else (2, n // 2)
    ints, subs = ints.reshape(shape), subs.reshape(shape)
    for enc, dec, arr in ((pt_pipeline.encode_bins, pt_pipeline.decode_bins, ints),
                          (pt_pipeline.encode_subbins, pt_pipeline.decode_subbins, subs)):
        ref_enc = getattr(ref_pipeline, enc.__name__)
        want = ref_enc(jnp.asarray(arr))
        got = enc(_t(arr))
        assert got == want, enc.__name__
        back = dec(got, n, shape, torch.int32 if dtype == np.int32 else torch.int64,
                   device="cpu")
        assert np.array_equal(back.numpy(), arr)
        ref_dec = getattr(ref_pipeline, dec.__name__)
        assert np.array_equal(np.asarray(ref_dec(got, n, shape, dtype)), arr)
    assert pt_pipeline.chunk_len_for(torch.int32) == ref_pipeline.chunk_len_for(jnp.int32)
    assert pt_pipeline.chunk_len_for(np.int64) == ref_pipeline.chunk_len_for(jnp.int64)
