"""Tile-local subbin fixed-point solve (port of
``repro.kernels.subbin_sweep.solve_tiles_blockwise``).

Every tile of a (B, t0+2, t1+2, t2+2) haloed int32 batch is relaxed,
halos held fixed, with synchronous (Jacobi) sweeps

    cur = max(cur, max_k[flag bit k](nbr_k + tie_k))

until no interior cell moves or ``tile_elems + 2`` sweeps ran.  Returns
the interiors and each tile's last-changed sweep index (0 for a tile
already at its fixed point).  The subbin lane is non-negative, which
both versions rely on (the reference's ``max(new, 0)`` is then a no-op).
"""
from __future__ import annotations

import torch

from ..core import topology
from . import _lib

_OFFS3 = topology.offsets(3)
_TIES3 = topology.tie_breaker(3)


def solve_tiles_blockwise_plain(sub_h: torch.Tensor, flags: torch.Tensor):
    """Op-for-op torch version of the Pallas kernel body, batched."""
    b, h0, h1, h2 = sub_h.shape
    max_iters = (h0 - 2) * (h1 - 2) * (h2 - 2) + 2
    full = sub_h.clone()
    need = [((flags >> k) & 1).bool() for k in range(len(_OFFS3))]

    def relax(cur):
        full[:, 1:-1, 1:-1, 1:-1] = cur
        new = cur
        for k, (ox, oy, oz) in enumerate(_OFFS3):
            nsub = full[:, 1 + ox : h0 - 1 + ox, 1 + oy : h1 - 1 + oy,
                        1 + oz : h2 - 1 + oz]
            cand = nsub + int(_TIES3[k])
            new = torch.maximum(new, torch.where(need[k], cand, 0))
        return new

    int0 = sub_h[:, 1:-1, 1:-1, 1:-1]
    cur = relax(int0)
    ch = (cur != int0).reshape(b, -1).any(dim=1)
    it = 1
    last = ch.to(torch.int32)
    while bool(ch.any()) and it < max_iters:
        new = relax(cur)
        ch = (new != cur).reshape(b, -1).any(dim=1)
        it += 1
        last = torch.where(ch, it, last)
        cur = new
    return cur.contiguous(), last


def solve_tiles_blockwise(sub_h: torch.Tensor, flags: torch.Tensor):
    """Solve a haloed tile batch -> (interiors (B, t0, t1, t2) int32,
    last-changed sweep (B,) int32): the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not sub_h.is_cuda:
        return solve_tiles_blockwise_plain(sub_h, flags)
    _lib.require_cuda(sub_h, flags)
    if sub_h.dtype != torch.int32 or flags.dtype != torch.int32:
        raise ValueError("solve_tiles_blockwise takes int32 subbins and flags")
    if sub_h.dim() != 4 or flags.dim() != 4:
        raise ValueError("solve_tiles_blockwise takes 4-D tile batches")
    b, h0, h1, h2 = sub_h.shape
    t = (h0 - 2, h1 - 2, h2 - 2)
    if tuple(flags.shape) != (b, *t) or min(t) < 1:
        raise ValueError(f"flags {tuple(flags.shape)} do not fit sub_h "
                         f"{tuple(sub_h.shape)}")
    out = torch.empty((b, *t), dtype=torch.int32, device=sub_h.device)
    iters = torch.empty((b,), dtype=torch.int32, device=sub_h.device)
    max_iters = t[0] * t[1] * t[2] + 2
    _lib.call("subbin_sweep", "lopc_solve_tiles", sub_h, flags, out, iters,
              b, *t, max_iters)
    _lib.LAUNCHES["solve_tiles_blockwise"] += 1
    return out, iters
