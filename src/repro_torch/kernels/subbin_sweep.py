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
    _lib.LAUNCHES.add("solve_tiles_blockwise_64" if wide
                      else "solve_tiles_blockwise")
    return out, iters


BAND = 8  # X-rows per band, the reference's
BAND_TILE = (16, 64)  # the band kernel's tile in Y and Z
# launches of the band kernel between two host reads of its change flags
BAND_CHECK_EVERY = 4
# passes after which a CTA of the band kernel stops; the next launch
# relaxes its tile again
BAND_MAX_PASSES = 4096
# which tiles a launch relaxes (csrc/subbin_sweep.cu): all, those whose X
# halo changed in the sweep before, those next to a tile that moved in
# the launch before
_ALL, _X_HALO, _YZ_HALO = 0, 1, 2


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

    On the card one launch relaxes 8 x 16 x 64 tiles of the bands to
    convergence in shared memory, in place: neighbours in the band are
    read from the current state (other tiles' cells as they stand), those
    in another band from a snapshot of every band's rows 0 and 7 taken at
    the sweep's start.  A solve's first launch relaxes every tile; a later
    sweep's first launch the tiles next to a tile of a neighbour band
    that moved in the sweep before (their X halo changed); a sweep's later
    launches the tiles next to a tile that moved in the launch before,
    and the tiles that ``BAND_MAX_PASSES`` passes did not take to
    convergence in it.  Each launch sets its own change flag; a launch
    whose predecessor in the batch changed nothing returns at once.  The
    host reads the flags every ``BAND_CHECK_EVERY`` launches: the first
    clear flag ends the sweep (its launch found every band at its fixed
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
    flags_p = flags3
    if xp != x:  # pad X to whole bands; the pad rows have no flags
        flags_p = torch.zeros((xp, y, z), dtype=torch.int32, device=dev)
        flags_p[:x] = flags3
    sub = torch.zeros((xp, y, z), dtype=torch.int32, device=dev)
    bands = sub.view(xp // BAND, BAND, y, z)
    snap = torch.empty((xp // BAND, 2, y, z), dtype=torch.int32, device=dev)
    n_tiles = xp // BAND * -(-y // BAND_TILE[0]) * -(-z // BAND_TILE[1])
    stamp = torch.full((n_tiles,), -1, dtype=torch.int32, device=dev)
    changed = torch.empty((BAND_CHECK_EVERY,), dtype=torch.int32, device=dev)
    sweeps = launch = 0
    since = -1  # the first launch of the sweep before; -1: none yet
    while True:
        snap[:, 0].copy_(bands[:, 0])
        snap[:, 1].copy_(bands[:, BAND - 1])
        first = launch
        sweep_moved = False
        while True:
            changed.zero_()
            for j in range(BAND_CHECK_EVERY):
                mode = (_YZ_HALO if launch > first
                        else _ALL if since < 0 else _X_HALO)
                _lib.call("subbin_sweep", "lopc_band_sweep", flags_p, sub,
                          snap, stamp, changed, j, launch, mode, since,
                          BAND_MAX_PASSES, xp, y, z)
                _lib.LAUNCHES.add("solve_blockwise")
                launch += 1
            moved = changed.tolist()
            if 0 in moved:
                # the first launch that changed nothing read the fixed point
                sweep_moved |= moved.index(0) > 0
                break
            sweep_moved = True
        sweeps += 1
        since = first
        if not sweep_moved:
            break
    return sub[:x].contiguous(), sweeps
