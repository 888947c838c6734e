"""Order-preserving float<->int bit mappings (port of
``repro.core.floatbits``).

    m(f) =  bits(f)            if bits(f) >= 0   (f >= +0.0)
            INT_MIN - bits(f)  otherwise         (f <= -0.0)

``m`` is strictly increasing over the finite floats, so
``nextafter^k(f) = m^-1(m(f) + k)`` is pure integer arithmetic, identical
on every backend.  ``INT_MIN - bits`` is intentional two's-complement
arithmetic: for negative ``bits`` it never overflows.
"""
from __future__ import annotations

import torch

_INT_DTYPE = {torch.float32: torch.int32, torch.float64: torch.int64}


def int_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Signed integer dtype with the same width as float ``dtype``."""
    try:
        return _INT_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"unsupported float dtype {dtype!r}; need float32/float64")


def float_to_ordered(x: torch.Tensor) -> torch.Tensor:
    """Monotone bijection: finite floats -> signed ints of equal width."""
    idt = int_dtype_for(x.dtype)
    bits = x.view(idt)
    imin = torch.iinfo(idt).min
    return torch.where(bits >= 0, bits, imin - bits)


def ordered_to_float(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`float_to_ordered`."""
    idt = int_dtype_for(dtype)
    m = m.to(idt)
    imin = torch.iinfo(idt).min
    bits = torch.where(m >= 0, m, imin - m)
    return bits.view(dtype)


def nextafter_k(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The k-th representable float above ``x`` (k >= 0, elementwise)."""
    idt = int_dtype_for(x.dtype)
    return ordered_to_float(float_to_ordered(x) + k.to(idt), x.dtype)
