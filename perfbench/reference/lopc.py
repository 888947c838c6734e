"""Plain reconstruction of an LOPC field, written from the method's
definition and the container format's value rule alone.

For a field ``x`` at a range-normalized bound ``eb``:

    eps_abs   = eb * (max x - min x)                 (1 for a constant field)
    eps       = eps_abs * (1 - 2**-20)
    base(b)   = smallest value of the field's dtype >= (b - 0.5) * eps
    bin(x)    = b with base(b) <= x < base(b + 1)
    subbin    = the least s >= 0 with s(p) >= s(n) + tie(n, p) for every
                Freudenthal neighbour n of p in p's bin that is less than
                p in Simulation-of-Simplicity order; tie = 1 where n's
                linear index is the greater
    value     = the subbin-th representable value at or above base(bin)

Arithmetic is read as an IEEE machine without subnormals reads it
(denormals are zero, results flushed), which is how the method is
specified.  The least fixed point is found by dense relaxation sweeps
over the whole field: no tiles, halos, kernels or containers.

Nothing here imports the program under test.
"""
from __future__ import annotations

import itertools

import torch

EPS_SHRINK = 1.0 - 2.0**-20
_INT = {torch.float32: torch.int32, torch.float64: torch.int64}


def offsets() -> list[tuple[int, int, int]]:
    """The 14 Freudenthal offsets of a 3-D grid, positive ones first."""
    pos = [o for o in itertools.product((0, 1), repeat=3) if any(o)]
    pos.sort(key=lambda o: (sum(o), o))
    return pos + [tuple(-c for c in o) for o in pos]


def slices(off, shape):
    """(destination, source) slices: dst[p] pairs with src[p + off]."""
    dst, src = [], []
    for o, n in zip(off, shape):
        dst.append(slice(max(0, -o), n - max(0, o)))
        src.append(slice(max(0, o), n + min(0, o)))
    return tuple(dst), tuple(src)


def flush(v: torch.Tensor) -> torch.Tensor:
    """Subnormals read as zeros of their sign."""
    tiny = torch.finfo(v.dtype).tiny
    return torch.where(v.abs() < tiny, v * 0, v)


def flush_scalar(v: float) -> float:
    return v * 0.0 if abs(v) < 2.2250738585072014e-308 else v


def to_ordered(v: torch.Tensor) -> torch.Tensor:
    """Monotone map of finite floats onto signed ints of their width."""
    idt = _INT[v.dtype]
    bits = v.view(idt)
    return torch.where(bits >= 0, bits, torch.iinfo(idt).min - bits)


def from_ordered(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    idt = _INT[dtype]
    m = m.to(idt)
    bits = torch.where(m >= 0, m, torch.iinfo(idt).min - m)
    return bits.view(dtype)


def abs_bound(x: torch.Tensor, eb: float) -> float:
    """The range-normalized bound in the field's units."""
    lo, hi = float(x.min()), float(x.max())
    rng = hi - lo
    return float(eb) * (rng if rng != 0.0 else 1.0)


def base(b: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """Smallest ``dtype`` value >= (b - 0.5) * eps."""
    t = flush((b.to(torch.float64) - 0.5) * flush_scalar(eps))
    v = flush(t.to(dtype))
    if dtype == torch.float64:
        return v
    up = from_ordered(to_ordered(v) + 1, dtype)
    return torch.where(v.to(torch.float64) < t, up, v)


def quantize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Bins: base(b) <= x < base(b + 1)."""
    x = flush(x)
    b = torch.round(flush(x.to(torch.float64) / flush_scalar(eps))).to(_INT[x.dtype])
    # the rounded quotient is at most one bin off; two checked steps fix it
    for _ in range(2):
        b = b - (x < flush(base(b, eps, x.dtype))).to(b.dtype) \
              + (x >= flush(base(b + 1, eps, x.dtype))).to(b.dtype)
    return b


def constraints(b: torch.Tensor, x: torch.Tensor):
    """Per offset: (dst, src, tie, mask) with mask[p] true where the
    neighbour p + off exists, shares p's bin and is SoS-less than p."""
    x = flush(x)
    out = []
    for off in offsets():
        dst, src = slices(off, x.shape)
        tie = int(sum(off) > 0)  # the neighbour has the greater index
        nv, v = x[src], x[dst]
        less = nv < v if tie else nv <= v
        out.append((dst, src, tie, (b[src] == b[dst]) & less))
    return out


def solve(b: torch.Tensor, x: torch.Tensor, check_every: int = 8) -> tuple[torch.Tensor, int]:
    """Least subbins meeting every constraint.  Returns (subbins int64,
    sweeps).  Each sweep relaxes the offsets in turn, in place, so a
    sweep may carry a value across several cells; from zeros every
    relaxation stays at or below the least solution, so the fixed point
    reached is it."""
    # per offset the increment a constrained pair adds, and a large
    # negative one where the pair is unconstrained
    steps = [(dst, src, torch.where(mask, tie, -2**30).to(torch.int32))
             for dst, src, tie, mask in constraints(b, x)]
    sub = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    sweeps = 0
    while True:
        before = sub.clone()
        for _ in range(check_every):
            for dst, src, add in steps:
                view = sub[dst]
                torch.maximum(view, sub[src] + add, out=view)
            sweeps += 1
        if torch.equal(sub, before):
            return sub.to(torch.int64), sweeps


def dequantize(b: torch.Tensor, sub: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """The sub-th representable value at or above base(b)."""
    m = to_ordered(base(b, eps, dtype)).to(torch.int64) + sub.to(torch.int64)
    return from_ordered(m, dtype)


def reconstruct(x: torch.Tensor, eb: float) -> tuple[torch.Tensor, float, int]:
    """What an LOPC decode of ``x`` at range-normalized ``eb`` must give.

    ``x`` is 1-, 2- or 3-D, float32 or float64; leading unit axes make it
    3-D (a missing axis has no neighbours).  Returns (values, eps_abs,
    sweeps)."""
    shape = x.shape
    x3 = x.reshape((1,) * (3 - x.dim()) + tuple(shape))
    eps_abs = abs_bound(x3, eb)
    eps = eps_abs * EPS_SHRINK
    b = quantize(x3, eps)
    sub, sweeps = solve(b, x3)
    return dequantize(b, sub, eps, x.dtype).reshape(shape), eps_abs, sweeps
