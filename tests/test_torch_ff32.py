"""The FF32 contract of the port against the JAX reference, on the CPU:
the plain versions of the FF32 quantize and dequantize kernels against
the reference's Pallas kernels in interpret mode (through
``repro.kernels.ops``), bit for bit, including NaN, infinite and
out-of-domain inputs; the FF32 round trip (quantize -> subbin solve ->
dequantize) keeping the bound, the local order and the critical points
through the port's own ``tda``.  Each CUDA kernel against its plain
version, on the card: tests/test_torch_cuda.py.

Inputs are made from seeds with numpy and handed to both packages.
Every comparison is exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import effective_eps
from repro.kernels import ops as ref_ops
from repro_torch.core import subbin as pt_subbin
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import fused_decode, quantize_kernel, ref
from repro_torch.kernels import ops as pt_ops
from repro_torch.tda import critical_point_errors, local_order_violations


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    g = got.numpy()
    return g.dtype == want.dtype and g.shape == want.shape and \
        g.tobytes() == want.tobytes()


# ---------------------------------------------------------- kernel 6

@pytest.mark.parametrize("n", [5, 128, 4096, 100_000])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_quantize_plain_matches_pallas(rng, n, scale):
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    eps = np.float32(scale * 1e-3)
    want = ref_ops.quantize_ff32(jnp.asarray(x), eps)
    got = pt_ops.quantize_ff32(_t(x), eps)
    assert _same_bits(got, want)


@pytest.mark.parametrize("eps", [1.0, 0.1, 3.0e-3, 7.5e2])
def test_quantize_nonfinite_and_out_of_domain_match_pallas(rng, eps):
    """NaN, infinities and |x / eps| at and beyond 2^23 and 2^31: the
    saturating float -> int32 conversion and the wrapping corrections
    must be the reference's (torch's own conversion is not)."""
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                        3e38, -3e38, 2.0**31, -(2.0**31), 2147483520.0,
                        -2147483520.0, 2.0**23, -(2.0**23), 2.0**23 + 2,
                        8388607.5, 0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    big = (rng.standard_normal(4000) * 2.0**rng.integers(20, 40, 4000))
    with np.errstate(over="ignore"):  # 3e38 * eps overflows to inf
        scaled = special * np.float32(eps)
    x = np.concatenate([scaled, special, big.astype(np.float32)]).astype(np.float32)
    assert not pt_ops.ff32_domain_ok(x, eps, device="cpu")
    want = ref_ops.quantize_ff32(jnp.asarray(x), np.float32(eps))
    got = pt_ops.quantize_ff32(_t(x), np.float32(eps))
    assert _same_bits(got, want)


def test_quantize_takes_any_shape_and_dtype(rng):
    x = rng.uniform(-5, 5, (7, 6, 5))
    eps = np.float32(0.01)
    want = ref_ops.quantize_ff32(jnp.asarray(x), eps)
    got = pt_ops.quantize_ff32(_t(x), eps)  # f64 input, cast to f32
    assert got.shape == (7, 6, 5) and _same_bits(got, want)


# ---------------------------------------------------------- kernel 7

@pytest.mark.parametrize("n", [7, 4096, 33_000])
def test_dequantize_plain_matches_pallas(rng, n):
    bins = rng.integers(-(2**22), 2**22, n).astype(np.int32)
    sub = rng.integers(0, 5, n).astype(np.int32)
    eps = np.float32(1e-2)
    want = ref_ops.dequantize_ff32(jnp.asarray(bins), jnp.asarray(sub), eps)
    got = pt_ops.dequantize_ff32(_t(bins), _t(sub), eps)
    assert _same_bits(got, want)


def test_dequantize_wrapping_matches_pallas(rng):
    """Bins out of the FF32 domain and subbins that wrap the int32
    ordered space: the reference's bits all the same."""
    i32 = np.iinfo(np.int32)
    bins = np.concatenate([
        np.array([i32.max, i32.min, 0, -1, 1, 2**23, -(2**23)], np.int32),
        rng.integers(i32.min, i32.max, 5000, dtype=np.int64).astype(np.int32)])
    sub = np.concatenate([
        np.array([i32.max, i32.max, i32.min, -1, 5, -7, 2**30], np.int32),
        rng.integers(i32.min, i32.max, 5000, dtype=np.int64).astype(np.int32)])
    for eps in (1e-2, 1.0, 3.0e5):
        want = ref_ops.dequantize_ff32(jnp.asarray(bins), jnp.asarray(sub),
                                       np.float32(eps))
        got = pt_ops.dequantize_ff32(_t(bins), _t(sub), np.float32(eps))
        assert _same_bits(got, want)


def test_dequantize_keeps_the_shape(rng):
    bins = rng.integers(-100, 100, (9, 4, 3)).astype(np.int32)
    sub = rng.integers(0, 3, (9, 4, 3)).astype(np.int32)
    eps = np.float32(0.25)
    want = ref_ops.dequantize_ff32(jnp.asarray(bins), jnp.asarray(sub), eps)
    got = pt_ops.dequantize_ff32(_t(bins), _t(sub), eps)
    assert got.shape == (9, 4, 3) and _same_bits(got, want)


def test_domain_check_matches_reference(rng):
    x = (rng.standard_normal(1000) * 50).astype(np.float32)
    for eps in (1e-6, 1e-5, 5e-6, 1.0):
        want = ref_ops.ff32_domain_ok(x, np.float32(eps))
        assert pt_ops.ff32_domain_ok(x, np.float32(eps), device="cpu") == want
        assert pt_ops.ff32_domain_ok(_t(x), np.float32(eps)) == want
    x[3] = np.nan
    assert not ref_ops.ff32_domain_ok(x, 1.0)
    assert not pt_ops.ff32_domain_ok(x, 1.0, device="cpu")
    assert not pt_ops.ff32_domain_ok(_t(x), 1.0)


# ------------------------------------------------- the FF32 round trip

@pytest.mark.parametrize("case", ["cumsum", "uniform"])
def test_ff32_round_trip_keeps_bound_order_and_critical_points(rng, case):
    """quantize_ff32 -> core.subbin.solve_subbins -> dequantize_ff32, as
    the reference's own FF32 tests run it, held by the port's ``tda``;
    the port's bins, subbins and values equal the reference's."""
    from repro.core.subbin import solve_subbins as ref_solve

    if case == "cumsum":
        x = (np.cumsum(rng.standard_normal((24, 18, 12)), 0) * 0.1).astype(np.float32)
        eb = 0.05
    else:
        x = rng.uniform(-1, 1, (6, 7, 5)).astype(np.float32)
        eb = 0.2
    eps = np.float32(effective_eps(eb))
    assert pt_ops.ff32_domain_ok(x, eps, device="cpu")
    bins = pt_ops.quantize_ff32(_t(x), eps)
    sub, _ = pt_subbin.solve_subbins(bins, _t(x), method="jacobi")
    y = pt_ops.dequantize_ff32(bins, sub, eps)
    assert float((_t(x).double() - y.double()).abs().max()) <= eb
    assert local_order_violations(_t(x), y) == 0
    assert critical_point_errors(_t(x), y) == (0, 0, 0)
    rbins = ref_ops.quantize_ff32(jnp.asarray(x), eps)
    rsub, _ = ref_solve(rbins, jnp.asarray(x), method="jacobi")
    ry = ref_ops.dequantize_ff32(rbins, rsub, eps)
    assert _same_bits(bins, rbins) and _same_bits(sub, rsub)
    assert _same_bits(y, ry)


def test_ff32_wrappers_take_the_plain_version_on_the_cpu():
    LAUNCHES.clear()
    x = torch.linspace(-1, 1, 50)
    b = quantize_kernel.quantize_ff32(x, 0.1)
    fused_decode.dequantize_ff32(b, torch.zeros_like(b), 0.1)
    assert LAUNCHES["quantize_ff32"] == 0 and LAUNCHES["dequantize_ff32"] == 0
    assert torch.equal(b, ref.quantize_ff32_ref(x, 0.1))
