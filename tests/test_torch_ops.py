"""The whole-field kernels, the subbin schedules and the v1 pipeline of
the port against the JAX reference, on the CPU: the plain versions of
the band solve, the BIT_4 transpose and the RZE bitmap against the
reference's Pallas kernels in interpret mode (through
``repro.kernels.ops``), bit for bit, with equal sweep counts; and, where
a CUDA device exists, each CUDA kernel against its plain version.

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
from repro.core.quantize import quantize as ref_quantize
from repro.data.fields import make_scientific_field as ref_field
from repro.kernels import ops as ref_ops
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
        back = dec(got, n, shape, torch.int32 if dtype == np.int32 else torch.int64)
        assert np.array_equal(back.numpy(), arr)
        ref_dec = getattr(ref_pipeline, dec.__name__)
        assert np.array_equal(np.asarray(ref_dec(got, n, shape, dtype)), arr)
    assert pt_pipeline.chunk_len_for(torch.int32) == ref_pipeline.chunk_len_for(jnp.int32)
    assert pt_pipeline.chunk_len_for(np.int64) == ref_pipeline.chunk_len_for(jnp.int64)


# ---------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["solve_blockwise", "bitshuffle_u32",
                                    "bitunshuffle_u32", "rze_bitmap_u32"])
def test_cuda_whole_field_kernel_matches_plain(rng, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(chip_smoke.py compares them there)")
    from repro_torch.core import topology
    from repro_torch.kernels import bitshuffle_kernel, ref, rze_kernel

    dev = torch.device("cuda")
    if kernel == "solve_blockwise":
        for bins, x in (_bins_values(rng.uniform(-1, 1, (37, 33, 29)), 0.5),
                        _long_chain()):
            flags = topology.order_flags(_t(bins).to(dev), _t(x).to(dev))
            got, got_sweeps = pt_ss.solve_blockwise(flags)
            want, want_sweeps = pt_ss.solve_blockwise_plain(flags)
            assert torch.equal(got, want) and got_sweeps == want_sweeps
        return
    words = _t(_words(rng, 9, "random").view(np.int32)).to(dev)
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
