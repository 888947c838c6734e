"""Plain PyTorch oracles of the whole-field kernels (port of
``repro.kernels.ref``).

``canonical3d`` is the 3-D view every whole-field solve runs on;
``bitshuffle_ref`` / ``bitunshuffle_ref`` and ``rze_bitmap_ref`` are the
plain versions of the BIT_4 transpose and the RZE bitmap kernels;
``quantize_ff32_ref`` and ``dequantize_ff32_ref`` those of the FF32
quantize and dequantize kernels.

FF32 precision contract
-----------------------
The FF32 pair bins and decodes with f32/int32 ops only:

    bin(x)  = rne(x * (1/eps32))                         (f32 multiply)
    base(b) = (f32(b) - 0.5) * eps32                     (f32 ops)
    fixup   : b -= [x < base(b)]; b += [x >= base(b+1)]  (twice)

Valid while |b| < 2^23 (``FF32_MAX_BIN``): then ``f32(b) +- 0.5`` is
exact and ``base`` is monotone; ``ops.ff32_domain_ok`` checks it.  Every
op is one IEEE f32 op, rounded on its own (no fused multiply-add), and
the float -> int32 conversion saturates (NaN -> 0, >= 2^31 -> INT32_MAX,
< -2^31 -> INT32_MIN) as the reference's does; the integer adds wrap.
Every subnormal operand and result (eps32, x, ``x * (1/eps32)``, the
bases) is flushed to a zero of its sign, as XLA's denormals-are-zero
and flush-to-zero arithmetic does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..codecs.bitshuffle import bitshuffle, bitunshuffle
from ..codecs.rze import rze_bitmap
from ..core.floatbits import float_to_ordered, ordered_to_float
from ..core.topology import flush_subnormals as _fz

FF32_MAX_BIN = 2**23  # |bin| must stay below this for base() exactness

_I32 = np.iinfo(np.int32)


def _f32(eps32, device) -> torch.Tensor:
    """``eps32`` as a 0-d f32 tensor (a python float rounds to nearest)."""
    return torch.tensor(np.float32(eps32), dtype=torch.float32, device=device)


def _rne_int32(v: torch.Tensor) -> torch.Tensor:
    """Round half to even, then a saturating conversion to int32."""
    r = torch.round(v)
    nan, hi, lo = torch.isnan(r), r >= 2.0**31, r < -(2.0**31)
    b = torch.where(nan | hi | lo, torch.zeros_like(r), r).to(torch.int32)
    b = torch.where(hi, _I32.max, b)
    return torch.where(lo, _I32.min, b)


def quantize_ff32_ref(x: torch.Tensor, eps32) -> torch.Tensor:
    """f32-only guaranteed binning (plain version of the FF32 quantize
    kernel): f32 ``x`` of any shape -> int32 bins of that shape."""
    x = _fz(x.to(torch.float32))
    eps = _fz(_f32(eps32, x.device))
    inv = _fz(torch.ones((), dtype=torch.float32, device=x.device) / eps)
    b = _rne_int32(_fz(x * inv))
    for _ in range(2):
        bf = b.to(torch.float32)
        lo = _fz((bf - 0.5) * eps)
        hi = _fz((bf + 0.5) * eps)
        b = b - (x < lo).to(torch.int32) + (x >= hi).to(torch.int32)
    return b


def decode_base_ff32(bins: torch.Tensor, eps32) -> torch.Tensor:
    return _fz((bins.to(torch.float32) - 0.5) * _fz(_f32(eps32, bins.device)))


def dequantize_ff32_ref(bins: torch.Tensor, subbins: torch.Tensor,
                        eps32) -> torch.Tensor:
    """Plain version of the FF32 dequantize kernel: the f32 base plus the
    subbin in int32 ordered space (wrapping), back to f32."""
    m = float_to_ordered(decode_base_ff32(bins, eps32)) + subbins.to(torch.int32)
    return ordered_to_float(m, torch.float32)


def canonical3d(x: torch.Tensor) -> torch.Tensor:
    """1-D and 2-D fields viewed as 3-D: (n,) -> (n, 1, 1), (a, b) ->
    (a, b, 1).  The Freudenthal 2-D (1-D) link is the 3-D link restricted
    to in-plane offsets, so flags and fixed point agree."""
    if x.dim() == 3:
        return x
    if x.dim() == 2:
        return x[:, :, None]
    return x[:, None, None]


def bitshuffle_ref(words: torch.Tensor) -> torch.Tensor:
    """(C, L) words -> their bit-planes (plain version of BIT_4)."""
    return bitshuffle(words)


def bitunshuffle_ref(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitshuffle_ref`."""
    return bitunshuffle(words)


def rze_bitmap_ref(words: torch.Tensor):
    """(C, L) words -> (MSB-first nonzero bitmap (C, L/W), counts (C,)
    int32): the plain version of the RZE bitmap kernel."""
    return rze_bitmap(words)
