"""Freudenthal mesh topology on regular grids (port of
``repro.core.topology``).

The link of a vertex is 2 / 6 / 14 neighbours in 1-D / 2-D / 3-D.
Comparisons use Simulation of Simplicity: ties in value are broken by
linear index, and for a Freudenthal offset the index comparison is a
constant (all components share one sign).  Comparisons are float
comparisons, not bit comparisons, so ``-0.0 == +0.0`` as in the
reference.

Order flags are packed into one 32-bit word per point (bit k set iff the
neighbour at offset k exists, has the same bin and is SoS-less).  Torch
has no uint32 arithmetic on the CPU, so the flags travel as int32: only
the low 14 bits are ever set.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def offsets(ndim: int) -> np.ndarray:
    """Freudenthal neighbour offsets, positive offsets first."""
    pos = []
    for mask in range(1, 2**ndim):
        off = tuple((mask >> (ndim - 1 - d)) & 1 for d in range(ndim))
        pos.append(off)
    pos.sort(key=lambda o: (sum(o), o))
    out = np.array(pos + [tuple(-c for c in o) for o in pos], dtype=np.int64)
    assert out.shape[0] == 2 * (2**ndim - 1)
    return out


@lru_cache(maxsize=None)
def tie_breaker(ndim: int) -> np.ndarray:
    """(K,) int32: 1 iff the neighbour's linear index is greater."""
    return (offsets(ndim).sum(axis=1) > 0).astype(np.int32)


def shift(x: torch.Tensor, off, fill) -> torch.Tensor:
    """out[p] = x[p + off], with ``fill`` outside the grid."""
    out = torch.full_like(x, fill)
    src, dst = [], []
    for o, n in zip(off, x.shape):
        o = int(o)
        src.append(slice(max(0, o), n + min(0, o)))
        dst.append(slice(max(0, -o), n - max(0, o)))
    out[tuple(dst)] = x[tuple(src)]
    return out


def sos_less(nv: torch.Tensor, v: torch.Tensor, k: int, ndim: int) -> torch.Tensor:
    """SoS comparison: neighbour (at offset k) < centre, ties by index."""
    if tie_breaker(ndim)[k] == 0:  # neighbour has the smaller index
        return (nv < v) | (nv == v)
    return nv < v


def order_flags(bins: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """int32 flags: bit k = neighbour k exists & same bin & SoS-less.

    Outside the grid, bins read a sentinel no quantized bin equals.
    """
    ndim = bins.dim()
    flags = torch.zeros(bins.shape, dtype=torch.int32, device=bins.device)
    sentinel = torch.iinfo(bins.dtype).min  # quantize never produces imin
    for k, off in enumerate(offsets(ndim)):
        nb = shift(bins, off, sentinel)
        nv = shift(values, off, float("inf"))
        bit = (nb == bins) & sos_less(nv, values, k, ndim)
        flags |= bit.to(torch.int32) << k
    return flags
