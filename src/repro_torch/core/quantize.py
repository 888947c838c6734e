"""Guaranteed-bound quantization (port of ``repro.core.quantize``).

    bin(x)        = round(x / eps)               (f64 intermediate math)
    base(b)       = smallest representable >= (b - 0.5) * eps
    x in bin b  <=>  base(b) <= x < base(b+1)

Every op is the reference's op, in the same order, in IEEE f64: ``/`` is
correctly rounded, ``torch.round`` rounds half to even like
``jnp.round``, and the f64 -> f32 cast rounds to nearest.  That is what
makes the port's bins bit-identical to the reference's on every device.

XLA runs with denormals-are-zero and flush-to-zero: an arithmetic op or
a comparison reads a subnormal operand as a zero of its sign and writes
a subnormal result as one; bitcasts and selects pass bits through.  So
each operand and result that can be subnormal is flushed here
(``_fz``): the cell value, eps, ``(b - 0.5) * eps`` and its cast, and
the bases the containment test compares.  Only a bound within about 2x
of ``finfo.tiny``, or subnormal cells, ever meets one.
"""
from __future__ import annotations

import numpy as np
import torch

from .floatbits import float_to_ordered, int_dtype_for, ordered_to_float
from .topology import flush_subnormals

_F64_TINY = float(np.finfo(np.float64).tiny)

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


def _fz(v):
    """``v`` (a tensor or a python float, read as f64) as XLA's arithmetic
    reads and writes it: a subnormal becomes a zero of its sign."""
    if isinstance(v, torch.Tensor):
        return flush_subnormals(v)
    return v * 0.0 if abs(v) < _F64_TINY else v


def decode_base(bins: torch.Tensor, eps, dtype: torch.dtype) -> torch.Tensor:
    """Smallest *representable* ``dtype`` value >= (b - 0.5) * eps, as the
    reference computes it (with its flushes, so below ``finfo.tiny`` the
    base is a zero or the bump above one).

    ``eps`` is a python float or an f64 tensor broadcastable to ``bins``.
    """
    t = _fz((bins.to(torch.float64) - 0.5) * _fz(eps))
    v = _fz(t.to(dtype))
    if dtype == torch.float64:
        return v
    # round-to-nearest may land below t: bump one ulp up so v >= t
    bumped = ordered_to_float(float_to_ordered(v) + 1, dtype)
    return torch.where(v.to(torch.float64) < t, bumped, v)


def quantize_broadcast(x: torch.Tensor, eps_b, dtype: torch.dtype) -> torch.Tensor:
    """The quantize op sequence with a broadcastable (per-tile) eps."""
    bdt = bin_dtype_for(dtype)
    x = _fz(x)
    xf = x.to(torch.float64)
    b = torch.round(_fz(xf / _fz(eps_b))).to(bdt)
    # verify-and-correct: containment in [base(b), base(b+1)) under the
    # same float comparisons the decoder uses; two passes cover the worst
    # realizable misplacement (|round error| <= 1 bin)
    for _ in range(2):
        too_high = x < _fz(decode_base(b, eps_b, dtype))
        too_low = x >= _fz(decode_base(b + 1, eps_b, dtype))
        b = b - too_high.to(bdt) + too_low.to(bdt)
    return b


def quantize(x: torch.Tensor, eps_abs: float) -> torch.Tensor:
    """Whole-field bins of width ``effective_eps(eps_abs)``:
    base(b) <= x < base(b+1) exactly, hence any decode inside the bin is
    within +-eps_abs of x."""
    return quantize_broadcast(x, effective_eps(eps_abs), x.dtype)


def dequantize(bins: torch.Tensor, subbins: torch.Tensor, eps_abs: float,
               dtype: torch.dtype) -> torch.Tensor:
    """Reconstruct: subbin k -> the k-th lowest representable float in
    the bin (``decode_base`` plus the subbin in ordered-int space)."""
    base = decode_base(bins, effective_eps(eps_abs), dtype)
    m = float_to_ordered(base) + subbins.to(int_dtype_for(dtype))
    return ordered_to_float(m, dtype)


def dequantize_tiles(bins: torch.Tensor, subbins: torch.Tensor,
                     eps: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(C, E) bins and subbins with a (C,) f64 eps per tile -> values:
    ``decode_base`` plus the subbin in ordered-int space.  A subbin
    stream wider than the ordered ints (an adaptive f32 field's ordered
    distances across a zero-straddling bin) accumulates in its own
    width; the final ordered value always fits the dtype's."""
    base = decode_base(bins, eps[:, None], dtype)
    idt = int_dtype_for(dtype)
    if subbins.element_size() > base.element_size():
        o = float_to_ordered(base).to(subbins.dtype) + subbins
        return ordered_to_float(o.to(idt), dtype)
    return ordered_to_float(float_to_ordered(base) + subbins.to(idt), dtype)


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
