"""Resident device stages of the engine (port of ``repro.engine.device``).

Every stage is a torch op or a kernel wrapper on tensors that stay on the
executor's device between stages; nothing crosses to the host between
the tile upload and the stream download except one boolean per halo
round (does any tile still move) and the subbin maximum.

The merged-3D layout: a (C, t0+2, t1+2, t2+2) haloed tile batch is
computed on as the 3-D array (C*(t0+2), t1+2, t2+2).  An interior cell's
14 Freudenthal neighbours all lie within its own tile's halo span, so
plain fill-shifts read the right cells for every interior; halo-row
results are sliced away.
"""
from __future__ import annotations

import torch

from ..core import topology
from ..core.quantize import quantize_broadcast
from ..kernels.fused_decode import decode_tiles_fused
from ..kernels.fused_encode import encode_ints_fused
from ..kernels.subbin_sweep import solve_tiles_blockwise

SOLVERS = ("auto", "jacobi", "frontier", "blockwise")


def _interior(x: torch.Tensor) -> torch.Tensor:
    return x[:, 1:-1, 1:-1, 1:-1]


def _merge(x4: torch.Tensor) -> torch.Tensor:
    c, h0, h1, h2 = x4.shape
    return x4.reshape(c * h0, h1, h2)


def _split_interior(x_m: torch.Tensor, c: int) -> torch.Tensor:
    h0 = x_m.shape[0] // c
    return x_m.reshape(c, h0, *x_m.shape[1:])[:, 1:-1, 1:-1, 1:-1]


def resident_quantize(x_h: torch.Tensor, eps: torch.Tensor, dtype: torch.dtype):
    """Quantize one resident tile batch.  NaN in ``x_h`` marks cells
    outside the field (tile pad, halo border, pad tiles).

    Returns (bins_enc (C, *t) with 0 at invalid cells, merged bins with
    the ``iinfo.min`` sentinel at invalid cells, merged values with
    ``+inf`` at invalid cells)."""
    valid_h = torch.isfinite(x_h)
    x0 = torch.where(valid_h, x_h, torch.zeros((), dtype=x_h.dtype,
                                                device=x_h.device))
    bins_h = quantize_broadcast(x0, eps[:, None, None, None], dtype)
    sentinel = torch.iinfo(bins_h.dtype).min
    bins_h = torch.where(valid_h, bins_h, sentinel)
    bins_enc = torch.where(_interior(valid_h), _interior(bins_h), 0)
    vals_m = _merge(torch.where(valid_h, x0, float("inf")))
    return bins_enc, _merge(bins_h), vals_m


def resident_flags(bins_m: torch.Tensor, vals_m: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Order flags on the merged layout -> (C, *t) int32 interiors."""
    flags_m = topology.order_flags(bins_m, vals_m)
    return _split_interior(flags_m, capacity).contiguous()


def resident_solve(flags: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                   max_rounds: int):
    """Subbin least fixed point over a resident tile batch.

    Rounds alternate one gather that rebuilds every haloed tile from the
    current interiors (``idx``/``mask`` from ``engine.halo``) and the
    tile-local solve to local convergence.  The loop ends when a round
    moves no tile (one host sync per round), which by monotonicity is the
    global least fixed point.

    Returns (interiors (C, *t) int32, local1 (C,) sweeps of the first
    local solve, last_round (C,) the last round in which the tile moved,
    rounds run).
    """
    c = flags.shape[0]
    halo_shape = (c,) + tuple(idx.shape[1:])
    idx_l = idx.reshape(-1).long()
    mask_f = mask.reshape(-1)
    cur = torch.zeros(flags.shape, dtype=torch.int32, device=flags.device)
    last_round = torch.zeros((c,), dtype=torch.int32, device=flags.device)
    local1 = last_round
    rnd = 1
    while rnd <= max_rounds:
        haloed = torch.where(mask_f, cur.reshape(-1)[idx_l], 0)
        new, iters = solve_tiles_blockwise(haloed.reshape(halo_shape), flags)
        ch_t = (new != cur).reshape(c, -1).any(dim=1)
        if rnd == 1:
            local1 = iters
        last_round = torch.where(ch_t, rnd, last_round)
        cur = new
        if not bool(ch_t.any()):
            break
        rnd += 1
    return cur, local1, last_round, min(rnd, max_rounds)


def encode_tiles(ints: torch.Tensor, chunk_len: int, transform: str):
    """Lossless stage over (C, tile_elems) resident integers ->
    (bitmap, shuffled words, counts) chunk rows."""
    return encode_ints_fused(ints, chunk_len, transform)


def sub_max(sub: torch.Tensor) -> int:
    """Largest subbin of the batch: the one scalar read back between the
    solve and the subbin encode, to pick the narrowest section width."""
    return int(sub.max())


def resident_decode_order(bitmap, packed, sub_bitmap, sub_packed, eps,
                          tile_elems: int, dtype: torch.dtype) -> torch.Tensor:
    """Decode an order-preserving tile batch -> (C, tile_elems) values."""
    return decode_tiles_fused(bitmap, packed, sub_bitmap, sub_packed, eps,
                              tile_elems, dtype)
