"""Subbin fixed-point solves (port of ``repro.kernels.subbin_sweep``).

``solve_tiles_blockwise`` (the tiled engine's solve): every tile of a
(B, t0+2, t1+2, t2+2) haloed batch is relaxed, halos held fixed, with
synchronous (Jacobi) sweeps

    cur = max(cur, max_k[flag bit k](nbr_k + tie_k))

until no interior cell moves or ``tile_elems + 2`` sweeps ran.  Returns
the interiors and each tile's last-changed sweep index (0 for a tile
already at its fixed point).  Two lanes: int32 subbins (non-negative),
and the adaptive path's ordered-space state, int32 for f32 fields and
int64 for f64 fields.  The reference carries that state biased and
unsigned with 0 as its neutral; the port carries the signed ordered int
itself, whose neutral is ``iinfo.min``, so a max only ever takes a
candidate whose flag bit is set (the reference's ``max(new, 0)`` with a
signed state would raise every negative value to 0).  The f32 lane runs
the int32 kernel; the int64 kernel counts as
``solve_tiles_blockwise_64``.

``solve_blockwise`` (the whole-field v1 solve): X is cut into ``BAND``-row
bands.  One global sweep relaxes every band to its own fixed point with
the neighbour bands' boundary rows read from the sweep-start state (the
band's halo; zero fill in Y and Z; the bands at both ends read a clamped
neighbour, whose rows no set flag bit ever consumes); global sweeps
repeat until one changes nothing, and that sweep is counted too.  A
band's result is the least fixed point above its sweep-start state with
its halo frozen, which is unique, so the schedule inside a band is free;
the sweep count is the reference's.
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
            new = torch.where(need[k], torch.maximum(new, cand), new)
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
    """Solve a haloed tile batch -> (interiors (B, t0, t1, t2) in
    ``sub_h``'s dtype (int32 or int64), last-changed sweep (B,) int32):
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if not sub_h.is_cuda:
        return solve_tiles_blockwise_plain(sub_h, flags)
    _lib.require_cuda(sub_h, flags)
    if sub_h.dtype not in (torch.int32, torch.int64) or flags.dtype != torch.int32:
        raise ValueError("solve_tiles_blockwise takes int32/int64 states and "
                         "int32 flags")
    if sub_h.dim() != 4 or flags.dim() != 4:
        raise ValueError("solve_tiles_blockwise takes 4-D tile batches")
    b, h0, h1, h2 = sub_h.shape
    t = (h0 - 2, h1 - 2, h2 - 2)
    if tuple(flags.shape) != (b, *t) or min(t) < 1:
        raise ValueError(f"flags {tuple(flags.shape)} do not fit sub_h "
                         f"{tuple(sub_h.shape)}")
    out = torch.empty((b, *t), dtype=sub_h.dtype, device=sub_h.device)
    iters = torch.empty((b,), dtype=torch.int32, device=sub_h.device)
    max_iters = t[0] * t[1] * t[2] + 2
    wide = sub_h.dtype == torch.int64
    _lib.call("subbin_sweep", "lopc_solve_tiles64" if wide else "lopc_solve_tiles",
              sub_h, flags, out, iters, b, *t, max_iters)
    _lib.LAUNCHES["solve_tiles_blockwise_64" if wide
                  else "solve_tiles_blockwise"] += 1
    return out, iters


BAND = 8  # X-rows per band, the reference's
# launches of the band kernel between two host reads of its change flags
BAND_CHECK_EVERY = 16


def _relax_bands(cur, halo_lo, halo_hi, need):
    """One relaxation of every (G, BAND, Y, Z) band given its (G, 1, Y, Z)
    halo rows (``_relax_band`` of the reference, for all bands at once)."""
    padded = torch.cat([halo_lo, cur, halo_hi], dim=1)
    _, _, y, z = cur.shape
    new = cur
    for k, (ox, oy, oz) in enumerate(_OFFS3):
        rows = padded[:, 1 + ox : 1 + ox + BAND]
        # shift in the (Y, Z) plane with zero fill
        nsub = torch.zeros_like(rows)
        nsub[:, :, max(0, -oy) : y - max(0, oy), max(0, -oz) : z - max(0, oz)] = (
            rows[:, :, max(0, oy) : y + min(0, oy), max(0, oz) : z + min(0, oz)])
        cand = nsub + int(_TIES3[k])
        new = torch.maximum(new, torch.where(need[k], cand, 0))
    return new


def solve_blockwise_plain(flags3: torch.Tensor):
    """Op-for-op torch version of ``_relax_band`` / ``_sweep_kernel`` /
    ``solve_blockwise``.  All bands relax together: a band at its fixed
    point is unchanged by another relaxation, so iterating until no band
    moves gives each band its own ``while`` loop's result.  Returns
    (subbins (X, Y, Z) int32, global sweeps)."""
    x, y, z = flags3.shape
    xp = -(-x // BAND) * BAND
    g = xp // BAND
    flags_p = torch.zeros((xp, y, z), dtype=flags3.dtype, device=flags3.device)
    flags_p[:x] = flags3
    fb = flags_p.reshape(g, BAND, y, z)
    need = [((fb >> k) & 1).bool() for k in range(len(_OFFS3))]
    lo_idx = torch.clamp(torch.arange(g, device=flags3.device) - 1, min=0)
    hi_idx = torch.clamp(torch.arange(g, device=flags3.device) + 1, max=g - 1)
    sub = torch.zeros((g, BAND, y, z), dtype=torch.int32, device=flags3.device)
    sweeps = 0
    while True:
        start = sub
        halo_lo = start[lo_idx, BAND - 1 :]
        halo_hi = start[hi_idx, :1]
        cur = _relax_bands(start, halo_lo, halo_hi, need)
        moved = bool((cur != start).any())
        while moved:
            new = _relax_bands(cur, halo_lo, halo_hi, need)
            moved = bool((new != cur).any())
            cur = new
        sweeps += 1
        if not bool((cur != start).any()):
            break
        sub = cur
    return sub.reshape(xp, y, z)[:x].contiguous(), sweeps


def solve_blockwise(flags3: torch.Tensor):
    """Whole-field band solve of (X, Y, Z) int32 flags -> (subbins
    (X, Y, Z) int32, global sweeps): the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors.

    On the card one launch relaxes every cell once (Jacobi, ping-ponging
    two buffers): neighbours in the cell's own band are read from the
    current state, those in another band from a snapshot of the
    sweep-start state.  Each launch sets its own change flag; a launch
    whose predecessor in the batch changed nothing returns at once.  The
    host reads the flags every ``BAND_CHECK_EVERY`` launches: the first
    clear flag ends the sweep (its launch's input is the band fixed
    point), and a sweep ending at its first launch ends the solve.
    """
    if not flags3.is_cuda:
        return solve_blockwise_plain(flags3)
    _lib.require_cuda(flags3)
    if flags3.dtype != torch.int32 or flags3.dim() != 3:
        raise ValueError("solve_blockwise takes (X, Y, Z) int32 flags")
    x, y, z = flags3.shape
    xp = -(-x // BAND) * BAND
    dev = flags3.device
    flags_p = torch.zeros((xp, y, z), dtype=torch.int32, device=dev)
    flags_p[:x] = flags3
    bufs = [torch.zeros((xp, y, z), dtype=torch.int32, device=dev),
            torch.empty((xp, y, z), dtype=torch.int32, device=dev)]
    snap = torch.empty_like(bufs[0])
    changed = torch.empty((BAND_CHECK_EVERY,), dtype=torch.int32, device=dev)
    sweeps = 0
    while True:
        snap.copy_(bufs[0])
        sweep_moved = False
        while True:
            changed.zero_()
            for j in range(BAND_CHECK_EVERY):
                _lib.call("subbin_sweep", "lopc_band_sweep", flags_p,
                          bufs[j % 2], snap, bufs[1 - j % 2], changed, j,
                          xp, y, z)
                _lib.LAUNCHES["solve_blockwise"] += 1
            moved = changed.tolist()
            if 0 in moved:
                stop = moved.index(0)
                sweep_moved |= stop > 0
                # launch `stop` changed nothing: its input is the fixed point
                if stop % 2:
                    bufs.reverse()
                break
            sweep_moved = True
            # an even number of launches leaves the state in bufs[0]
        sweeps += 1
        if not sweep_moved:
            break
    return bufs[0][:x].contiguous(), sweeps
