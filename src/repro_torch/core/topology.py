"""Freudenthal mesh topology on regular grids (port of
``repro.core.topology``).

The link of a vertex is 2 / 6 / 14 neighbours in 1-D / 2-D / 3-D.
Comparisons use Simulation of Simplicity: ties in value are broken by
linear index, and for a Freudenthal offset the index comparison is a
constant (all components share one sign).  Comparisons are float
comparisons, not bit comparisons, so ``-0.0 == +0.0`` as in the
reference.

Order flags are packed into one 32-bit word per point (bit k set iff the
neighbour at offset k exists, has the same bin and is SoS-less;
``order_flags_all`` drops the same-bin test).  Torch has no uint32
arithmetic on the CPU, so the flags travel as int32: only the low 14
bits are ever set.

Two link vertices are adjacent in the link iff their difference is
itself a Freudenthal offset (``link_adjacency``): the link graph the
critical-point census counts components on.
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
def n_neighbors(ndim: int) -> int:
    return offsets(ndim).shape[0]


def _is_offset(delta: np.ndarray) -> bool:
    """Is ``delta`` a Freudenthal offset (all components of one sign, not 0)?"""
    if not delta.any():
        return False
    return bool(np.all((delta == 0) | (delta == 1))
                or np.all((delta == 0) | (delta == -1)))


@lru_cache(maxsize=None)
def link_adjacency(ndim: int) -> np.ndarray:
    """(K, K) bool: link vertices u, v adjacent iff u - v is an offset."""
    offs = offsets(ndim)
    k = offs.shape[0]
    adj = np.zeros((k, k), dtype=bool)
    for i in range(k):
        for j in range(k):
            if i != j:
                adj[i, j] = _is_offset(offs[i] - offs[j])
    assert (adj == adj.T).all()
    return adj


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


def flush_subnormals(values: torch.Tensor) -> torch.Tensor:
    """``values`` with every subnormal replaced by a zero of its sign: the
    operands the reference's comparisons see, since XLA runs with
    denormals-are-zero on the CPU (and the TPU has no subnormals).  Order
    flags and the critical-point census compare these, so a run of
    subnormal values is a run of SoS ties there as in the reference."""
    tiny = torch.finfo(values.dtype).tiny
    return torch.where(values.abs() < tiny, values * 0, values)


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
    values = flush_subnormals(values)
    flags = torch.zeros(bins.shape, dtype=torch.int32, device=bins.device)
    sentinel = torch.iinfo(bins.dtype).min  # quantize never produces imin
    for k, off in enumerate(offsets(ndim)):
        nb = shift(bins, off, sentinel)
        nv = shift(values, off, float("inf"))
        bit = (nb == bins) & sos_less(nv, values, k, ndim)
        flags |= bit.to(torch.int32) << k
    return flags


def order_flags_all(values: torch.Tensor) -> torch.Tensor:
    """int32 flags: bit k = neighbour k exists (in-field) & SoS-less, the
    all-pairs variant (no same-bin test) the adaptive ordered-space solve
    enforces, where cross-bin and cross-eps pairs carry real constraints.

    Cells outside the field hold +inf, which kills every pair touching
    them: an invalid centre through the isfinite mask, an invalid
    neighbour through the comparison (+inf is never SoS-less than a
    finite centre).
    """
    ndim = values.dim()
    values = flush_subnormals(values)
    flags = torch.zeros(values.shape, dtype=torch.int32, device=values.device)
    finite = torch.isfinite(values)
    for k, off in enumerate(offsets(ndim)):
        nv = shift(values, off, float("inf"))
        bit = finite & sos_less(nv, values, k, ndim)
        flags |= bit.to(torch.int32) << k
    return flags
