"""Guaranteed-bound quantization (port of ``repro.core.quantize``).

    bin(x)        = round(x / eps)               (f64 intermediate math)
    base(b)       = smallest representable >= (b - 0.5) * eps
    x in bin b  <=>  base(b) <= x < base(b+1)

Every op is the reference's op, in the same order, in IEEE f64: ``/`` is
correctly rounded, ``torch.round`` rounds half to even like
``jnp.round``, and the f64 -> f32 cast rounds to nearest.  That is what
makes the port's bins bit-identical to the reference's on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from .floatbits import float_to_ordered, ordered_to_float

# Relative shrink applied to the user's bound (see the reference).
EPS_SHRINK = 1.0 - 2.0**-20

_BIN_DTYPE = {torch.float32: torch.int32, torch.float64: torch.int64}
_NP_BIN_DTYPE = {np.dtype(np.float32): np.dtype(np.int32),
                 np.dtype(np.float64): np.dtype(np.int64)}

# f64 bins beyond 2^51 lose exactness in the (b - 0.5) * eps decode math.
F64_EXACT_BIN_LIMIT = 2.0**51


def bin_dtype_for(dtype) -> torch.dtype:
    """Bin dtype of a float dtype: a torch dtype for a torch dtype, a
    numpy dtype for anything numpy understands."""
    if isinstance(dtype, torch.dtype):
        return _BIN_DTYPE[dtype]
    return _NP_BIN_DTYPE[np.dtype(dtype)]


def effective_eps(eb_abs: float) -> float:
    """The internally used (slightly shrunk) absolute bound."""
    return float(eb_abs) * EPS_SHRINK


def abs_bound_from_mode(x, eb: float, mode: str) -> float:
    """Resolve an ABS or NOA (range-normalized) bound to absolute."""
    if mode == "abs":
        return float(eb)
    if mode == "noa":
        lo = float(np.min(x))
        hi = float(np.max(x))
        rng = hi - lo
        if rng == 0.0:
            rng = 1.0  # constant field: any positive eps preserves it
        return float(eb) * rng
    raise ValueError(f"unknown error-bound mode {mode!r} (want 'abs'|'noa')")


def decode_base(bins: torch.Tensor, eps, dtype: torch.dtype) -> torch.Tensor:
    """Smallest *representable* ``dtype`` value >= (b - 0.5) * eps.

    ``eps`` is a python float or an f64 tensor broadcastable to ``bins``.
    """
    t = (bins.to(torch.float64) - 0.5) * eps
    v = t.to(dtype)
    if dtype == torch.float64:
        return v
    # round-to-nearest may land below t: bump one ulp up so v >= t
    bumped = ordered_to_float(float_to_ordered(v) + 1, dtype)
    return torch.where(v.to(torch.float64) < t, bumped, v)


def quantize_broadcast(x: torch.Tensor, eps_b, dtype: torch.dtype) -> torch.Tensor:
    """The quantize op sequence with a broadcastable (per-tile) eps."""
    bdt = bin_dtype_for(dtype)
    xf = x.to(torch.float64)
    b = torch.round(xf / eps_b).to(bdt)
    # verify-and-correct: containment in [base(b), base(b+1)) under the
    # same float comparisons the decoder uses; two passes cover the worst
    # realizable misplacement (|round error| <= 1 bin)
    for _ in range(2):
        too_high = x < decode_base(b, eps_b, dtype)
        too_low = x >= decode_base(b + 1, eps_b, dtype)
        b = b - too_high.to(bdt) + too_low.to(bdt)
    return b


def max_abs_bin(dtype) -> float:
    """Largest |bin| for which the error-bound guarantee holds."""
    int_limit = float(np.iinfo(bin_dtype_for(np.dtype(dtype))).max) * 0.5
    return min(int_limit, F64_EXACT_BIN_LIMIT)


def check_bin_range(x: np.ndarray, eps_abs: float) -> None:
    """Reject inputs whose bins would overflow the exact-math domain."""
    eps = effective_eps(eps_abs)
    max_bin = float(np.max(np.abs(np.asarray(x, np.float64)))) / eps
    if max_bin > max_abs_bin(x.dtype):
        raise ValueError(
            f"|x|/eps = {max_bin:.3g} overflows {bin_dtype_for(x.dtype)} "
            "bins; use a looser bound or float64 input"
        )
