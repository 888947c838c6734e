"""The port's ``tda`` and all-pairs order flags against the JAX
reference, on the CPU: critical signatures and classes, the
critical-point errors and local-order counts, ``order_flags_all``, and
the adaptive eb ladder (its per-tile scores and ``ladder_indices`` rung
for rung, including a field where ``tighten_ladder`` raises rungs), and
the quality metrics ``psnr`` and ``ssim``.

Inputs are made from seeds with numpy and handed to both packages.
Every comparison is exact.
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tda.adaptive as ref_adaptive
from repro.core import topology as ref_topology
from repro.data.fields import make_scientific_field as ref_field
from repro.engine.plan import CompressionPlan
from repro.tda import critpoints as ref_cp
from repro.tda import quality as ref_quality
from repro_torch.core import topology as pt_topology
from repro_torch.engine.plan import CompressionPlan as PtPlan
from repro_torch.tda import adaptive as pt_adaptive
from repro_torch.tda import critpoints as pt_cp

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_order_properties import make_family  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _field(kind: str, shape, rng):
    if kind == "random":
        return rng.standard_normal(shape)
    # plateaus: long runs of exactly equal values, pure SoS ties
    return np.round(rng.standard_normal(shape) * 1.5) / 2.0


def staircase(dtype, seed: int = 0) -> np.ndarray:
    """1-D field of five noisy (4096,) tiles and a smooth ramp tile; at
    every tile boundary the left cell lies just above the right one.  The
    noisy tiles score the loosest rung and the ramp the tightest, and the
    boundaries' decode anchors invert at mixed rungs, so
    ``tighten_ladder`` raises rungs over several rounds; in f64 what its
    rounds leave needs 8-byte subbin sections."""
    rng = np.random.default_rng(seed)
    n = 4096
    x = np.concatenate([rng.standard_normal(n) for _ in range(5)]
                       + [np.linspace(0.0, 0.05, n)])
    for t in range(1, 6):
        w = rng.uniform(-0.5, 0.5)
        x[t * n] = w
        x[t * n - 1] = w + 1e-9
    return x.astype(dtype)


# ------------------------------------------------------- critpoints

@pytest.mark.parametrize("shape", [(300,), (23, 19), (11, 9, 7)])
@pytest.mark.parametrize("kind", ["random", "plateau"])
def test_critical_signature_and_classes_match_reference(rng, shape, kind):
    x = _field(kind, shape, rng)
    lo_r, up_r = ref_cp.critical_signature(jnp.asarray(x))
    lo, up = pt_cp.critical_signature(_t(x))
    assert lo.dtype == torch.int8 and up.dtype == torch.int8
    assert np.array_equal(lo.numpy(), np.asarray(lo_r))
    assert np.array_equal(up.numpy(), np.asarray(up_r))
    cls = pt_cp.classify_critical_points(x, device="cpu")
    assert cls.dtype == torch.int8
    assert np.array_equal(cls.numpy(),
                          np.asarray(ref_cp.classify_critical_points(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(400,), (30, 21), (12, 10, 9)])
def test_error_counts_match_reference(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    y = x + rng.standard_normal(shape).astype(np.float32) * 0.3
    y[rng.random(shape) < 0.5] = x[rng.random(shape) < 0.5].mean()
    assert pt_cp.critical_point_errors(x, y, device="cpu") == \
        ref_cp.critical_point_errors(x, y)
    assert pt_cp.local_order_violations(x, y, device="cpu") == \
        ref_cp.local_order_violations(x, y)
    assert pt_cp.local_order_violations(x, x, device="cpu") == 0
    assert pt_cp.critical_point_errors(_t(x), _t(x)) == (0, 0, 0)


def test_subnormal_values_compare_as_zero_as_in_the_reference():
    """XLA on the CPU treats subnormal operands as zero: a run of them is
    a run of SoS ties in the reference's census and flags, and so in the
    port's."""
    tiny = np.finfo(np.float32).tiny
    x = np.array([[3, -2, 1, 5], [-7, 2, -1, 4], [6, 1, -3, 2]],
                 np.float32) * np.float32(tiny / 16)
    x[0, 0] = 1.0
    lo_r, up_r = ref_cp.critical_signature(jnp.asarray(x))
    lo, up = pt_cp.critical_signature(x, device="cpu")
    assert np.array_equal(lo.numpy(), np.asarray(lo_r))
    assert np.array_equal(up.numpy(), np.asarray(up_r))
    want = np.asarray(ref_topology.order_flags_all(jnp.asarray(x)))
    assert np.array_equal(pt_topology.order_flags_all(_t(x)).numpy(),
                          want.astype(np.int32))


# ---------------------------------------------------- topology

@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_link_adjacency_matches_reference(ndim):
    assert np.array_equal(pt_topology.link_adjacency(ndim),
                          ref_topology.link_adjacency(ndim))
    assert pt_topology.n_neighbors(ndim) == ref_topology.n_neighbors(ndim)


@pytest.mark.parametrize("shape", [(50,), (13, 17), (9, 8, 7)])
def test_order_flags_all_matches_reference(rng, shape):
    x = np.round(rng.standard_normal(shape) * 2.0) / 2.0  # ties too
    x[rng.random(shape) < 0.1] = np.inf  # outside cells kill their pairs
    want = np.asarray(ref_topology.order_flags_all(jnp.asarray(x)))
    got = pt_topology.order_flags_all(_t(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int32))


# ---------------------------------------------------- the eb ladder

GENERATOR_CASES = [(name, dt) for name in ("front", "gaussians", "turbulence",
                                           "waves")
                   for dt in ("float32", "float64")]


def _ref_and_port_layout(shape):
    return CompressionPlan().layout_for(shape), PtPlan().layout_for(shape)


@pytest.mark.parametrize("name,dtype", GENERATOR_CASES)
def test_tile_scores_match_reference(name, dtype):
    x = ref_field(name, (17, 14, 12), np.dtype(dtype), seed=5)
    lay_r, lay = _ref_and_port_layout(x.shape)
    x3 = np.asarray(x, np.float64).reshape(lay.canonical)
    for a, b in zip(pt_adaptive.tile_relief(x3, lay, device="cpu"),
                    ref_adaptive.tile_relief(x3, lay_r)):
        assert np.array_equal(a, b)
    assert pt_adaptive.tile_noise_scale(x3, lay, device="cpu").tobytes() == \
        ref_adaptive.tile_noise_scale(x3, lay_r).tobytes()
    for a, b in zip(pt_adaptive.critical_counts(x, lay, device="cpu"),
                    ref_adaptive.critical_counts(x, lay_r)):
        assert np.array_equal(a, b)
    assert np.array_equal(pt_adaptive.critical_tiles(x, lay, device="cpu"),
                          ref_adaptive.critical_tiles(x, lay_r))


def test_noise_scale_takes_numpys_median_of_even_and_odd_counts(rng):
    """Tiles with an even number of second differences average the two
    middle values (``np.nanmedian``), odd ones take the middle one, on
    long and on short rows (``np.nanmedian`` takes two code paths)."""
    for shape in ((40, 33, 70), (5, 7), (9, 3, 2)):
        x3 = rng.standard_normal(shape)
        lay_r, lay = _ref_and_port_layout(shape)
        x3 = x3.reshape(lay.canonical)
        assert pt_adaptive.tile_noise_scale(x3, lay, device="cpu").tobytes() == \
            ref_adaptive.tile_noise_scale(x3, lay_r).tobytes()


LADDER_CASES = (
    [("gen", name, dt) for name, dt in GENERATOR_CASES]
    + [("family", fam, dt) for fam in ("smooth", "noisy", "plateau")
       for dt in ("float32", "float64")]
    + [("shape", "1d", "float64"), ("shape", "2d", "float32")])


@pytest.mark.parametrize("kind,name,dtype", LADDER_CASES)
def test_ladder_indices_match_reference(rng, kind, name, dtype):
    if kind == "gen":
        x = ref_field(name, (17, 14, 12), np.dtype(dtype), seed=5)
    elif kind == "family":
        x = make_family(name, (12, 10, 8), np.dtype(dtype))
    else:
        shape = (9000,) if name == "1d" else (70, 90)
        x = (np.cumsum(rng.standard_normal(shape), axis=0)
             + rng.standard_normal(shape) * (rng.random(shape) < 0.3)).astype(dtype)
    lay_r, lay = _ref_and_port_layout(x.shape)
    eps = 1e-2 * (float(x.max()) - float(x.min()))
    want = ref_adaptive.ladder_indices(x, lay_r, eps)
    got = pt_adaptive.ladder_indices(x, lay, eps, device="cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tighten_ladder_raises_rungs_as_the_reference(dtype):
    x = staircase(np.dtype(dtype))
    lay_r, lay = _ref_and_port_layout(x.shape)
    eps = 1e-2 * (float(x.max()) - float(x.min()))
    seen = {}
    tighten = ref_adaptive.tighten_ladder

    def spy(x_, layout, ladder, eps_abs, k_max=3):
        seen["before"] = np.array(ladder)
        return tighten(x_, layout, ladder, eps_abs, k_max)

    ref_adaptive.tighten_ladder = spy
    try:
        want = ref_adaptive.ladder_indices(x, lay_r, eps)
    finally:
        ref_adaptive.tighten_ladder = tighten
    assert (want > seen["before"]).any(), "tighten_ladder raised no rung"
    got = pt_adaptive.ladder_indices(x, lay, eps, device="cpu")
    assert np.array_equal(got, want)
    assert np.array_equal(
        pt_adaptive.tighten_ladder(x, lay, seen["before"], eps, device="cpu"),
        want)


def test_ladder_rejects_a_non_finite_field():
    x = np.ones((8, 8))
    x[2, 3] = np.nan
    with pytest.raises(ValueError, match="finite"):
        pt_adaptive.ladder_indices(x, PtPlan().layout_for(x.shape), 0.1,
                                   device="cpu")
    flat = np.full((8, 8), 3.0)
    assert not pt_adaptive.ladder_indices(flat, PtPlan().layout_for(flat.shape),
                                          0.1, device="cpu").any()


@pytest.mark.parametrize("shape", [(300,), (23, 19), (11, 9, 7)])
def test_quality_metrics_match_reference(rng, shape):
    from repro_torch import tda

    assert {"psnr", "ssim"} <= set(tda.__all__)
    x = rng.standard_normal(shape)
    noisy = x + 1e-3 * rng.standard_normal(shape)
    flat = np.full(shape, 2.5)
    cases = [(x, noisy, 7), (x.astype(np.float32), noisy, 3), (x, x, 7),
             (flat, flat + 1e-6, 7), (flat, flat, 7), (x, noisy, 1)]
    for o, r, window in cases:
        for name in ("psnr", "ssim"):
            kw = {"window": window} if name == "ssim" else {}
            want = getattr(ref_quality, name)(o, r, **kw)
            got = getattr(tda, name)(o, r, **kw)
            assert type(got) is float
            assert np.array_equal(got, want), (name, window)
    assert tda.psnr(x, x) == float("inf")
    assert tda.psnr(flat, flat + 1e-6) == float("-inf")
    with pytest.raises(ValueError, match="window"):
        tda.ssim(x, x, window=0)
