"""Bounds within 2x of the smallest normal, and subnormal cells, against
the JAX reference on the CPU.

XLA runs with denormals-are-zero and flush-to-zero, so where a bin
width, a cell value or a decode base ``(b - 0.5) * eps`` is subnormal the
reference computes with a zero of the same sign.  The port flushes those
operands and results explicitly (``core.quantize``, ``kernels.ref`` and
the quantize and decode kernels); these cases hold its containers and
decodes to the reference's bits.  At eb = 1.5 * tiny each case meets such
a flush; at 4 * tiny none does.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro import engine as ref_engine
from repro.kernels import ops as ref_ops
from repro_torch import core as pt_core
from repro_torch import engine as pt_engine
from repro_torch.data.fields import make_scientific_field
from repro_torch.kernels import ops as pt_ops

DTYPES = {"f32": np.float32, "f64": np.float64}


def _field(kind: str, dtype, shape=(8, 16, 16), seed=0) -> np.ndarray:
    """``subnormal``: cells of 4 * tiny * N(0, 1), about a fifth of them
    subnormal; ``normal``: cells of either sign with |x| in [tiny,
    8 * tiny]; ``smooth``: 4 * tiny times a smooth wave field in [-1, 1]
    (few critical points, so the adaptive ladder keeps the user bound)."""
    rng = np.random.default_rng(seed)
    tiny = np.finfo(dtype).tiny
    if kind == "subnormal":
        return (4 * tiny * rng.standard_normal(shape)).astype(dtype)
    if kind == "normal":
        sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
        return (sign * rng.uniform(1.0, 8.0, shape) * tiny).astype(dtype)
    f = make_scientific_field("waves", shape, np.float64, seed=seed + 3)
    f = (f - f.min()) / (f.max() - f.min()) * 2 - 1
    return (4 * tiny * f).astype(dtype)


def _bound(dtype, mult: float) -> float:
    return mult * float(np.finfo(dtype).tiny)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# (field kind, preserve_order)
KINDS = {
    "subnormal-cells": ("subnormal", True),
    "normal-cells": ("normal", True),
    "normal-cells-plain": ("normal", False),
}


@pytest.mark.parametrize("mult", [1.5, 4.0])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_engine_container_and_decode_equal_reference(dt, kind, mult):
    field, order = KINDS[kind]
    dtype = DTYPES[dt]
    x = _field(field, dtype)
    eb = _bound(dtype, mult)
    want = ref_engine.compress(x, eb, mode="abs", preserve_order=order,
                               solver="blockwise")
    got = pt_engine.compress(x, eb, mode="abs", preserve_order=order,
                             device="cpu")
    assert got == want
    assert _same_bits(pt_engine.decompress(got, device="cpu"),
                      ref_engine.decompress(want))


@pytest.mark.parametrize("kind", ["subnormal", "normal"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_v1_container_and_decode_equal_reference(dt, kind):
    dtype = DTYPES[dt]
    x = _field(kind, dtype, shape=(6, 10, 12), seed=1)
    eb = _bound(dtype, 1.5)
    want = ref_core.compress(x, eb, mode="abs", container_version=1)
    got = pt_core.compress(x, eb, mode="abs", container_version=1,
                           device="cpu")
    assert got == want
    assert _same_bits(pt_core.decompress(got, device="cpu"),
                      ref_core.decompress(want))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_adaptive_container_and_decode_equal_reference(dt):
    dtype = DTYPES[dt]
    x = _field("smooth", dtype)
    eb = _bound(dtype, 1.5)
    want = ref_engine.compress(x, eb, mode="abs", adaptive_eb="tda")
    got = pt_engine.compress(x, eb, mode="abs", adaptive_eb="tda",
                             device="cpu")
    assert got == want
    assert _same_bits(pt_engine.decompress(got, device="cpu"),
                      ref_engine.decompress(want))


@pytest.mark.parametrize("mult", [0.9999999, 1.5])
def test_ff32_pair_equals_reference(mult):
    """The FF32 pair at a subnormal and at a near-tiny f32 bin width."""
    rng = np.random.default_rng(2)
    tiny = np.finfo(np.float32).tiny
    eps = np.float32(mult * tiny)
    x = (4 * tiny * rng.standard_normal(5000)).astype(np.float32)
    want = np.array(ref_ops.quantize_ff32(jnp.asarray(x), eps))
    got = pt_ops.quantize_ff32(torch.from_numpy(x), eps).numpy()
    assert _same_bits(got, want)
    sub = rng.integers(0, 3, x.shape).astype(np.int32)
    want_y = np.asarray(ref_ops.dequantize_ff32(jnp.asarray(want),
                                                jnp.asarray(sub), eps))
    got_y = pt_ops.dequantize_ff32(torch.from_numpy(want),
                                   torch.from_numpy(sub), eps).numpy()
    assert _same_bits(got_y, want_y)
