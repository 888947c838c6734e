"""Resident device stages of the engine (port of ``repro.engine.device``).

Every stage is a torch op or a kernel wrapper on tensors that stay on the
executor's device between stages; nothing crosses to the host between
the tile upload and the stream download except two counts per halo
round (tiles that moved, tiles to solve next), the subbin maximum and,
on the compacted download, the stream totals.

The merged-3D layout: a (C, t0+2, t1+2, t2+2) haloed tile batch is
computed on as the 3-D array (C*(t0+2), t1+2, t2+2).  An interior cell's
14 Freudenthal neighbours all lie within its own tile's halo span, so
plain fill-shifts read the right cells for every interior; halo-row
results are sliced away.
"""
from __future__ import annotations

from collections import deque

import torch

from ..core import topology
from ..core.floatbits import float_to_ordered
from ..core.quantize import decode_base, quantize_broadcast
# the chain's dequantize stage, shared with kernel 3's plain version
from ..core.quantize import dequantize_tiles  # noqa: F401
from ..kernels.fused_decode import decode_tiles_fused, expand_ints
from ..kernels.fused_encode import encode_ints_fused, encode_values_fused
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


def resident_quantize(x_h: torch.Tensor, eps: torch.Tensor, dtype: torch.dtype,
                      preserve_order: bool = True):
    """Quantize one resident tile batch.  NaN in ``x_h`` marks cells
    outside the field (tile pad, halo border, pad tiles).

    Returns (bins_enc (C, *t) with 0 at invalid cells, merged bins with
    the ``iinfo.min`` sentinel at invalid cells, merged values with
    ``+inf`` at invalid cells); the plain path needs only the first, and
    gets ``None`` for the other two."""
    valid_h = torch.isfinite(x_h)
    x0 = torch.where(valid_h, x_h, torch.zeros((), dtype=x_h.dtype,
                                                device=x_h.device))
    bins_h = quantize_broadcast(x0, eps[:, None, None, None], dtype)
    sentinel = torch.iinfo(bins_h.dtype).min
    bins_h = torch.where(valid_h, bins_h, sentinel)
    bins_enc = torch.where(_interior(valid_h), _interior(bins_h), 0)
    if not preserve_order:
        return bins_enc, None, None
    vals_m = _merge(torch.where(valid_h, x0, float("inf")))
    return bins_enc, _merge(bins_h), vals_m


def resident_flags(bins_m: torch.Tensor, vals_m: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Order flags on the merged layout -> (C, *t) int32 interiors."""
    flags_m = topology.order_flags(bins_m, vals_m)
    return _split_interior(flags_m, capacity).contiguous()


# tiles solved in each round of the last resident solves, newest last
SOLVED_TILES: deque = deque(maxlen=64)


def resident_solve(flags: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                   max_rounds: int, adjacency: tuple[torch.Tensor, torch.Tensor],
                   sub0: torch.Tensor | None = None, n_real: int | None = None):
    """Least fixed point over a resident tile batch.

    Rounds alternate one gather that rebuilds haloed tiles from the
    current interiors (``idx``/``mask`` from ``engine.halo``) and the
    tile-local solve to local convergence.  The loop ends when a round
    moves no tile, which by monotonicity is the global least fixed point.

    Round 1 solves every real tile (``0..n_real-1``; the pad tiles after
    them have no flags and are never solved, their interiors stay at the
    start state).  From round 2 on only the tiles whose halo reads a tile
    that moved in the round before are gathered and solved (``adjacency``:
    the (dst, src) int64 tile pairs of ``halo.group_adjacency`` on the
    device, dst's halo reading src's interior): a tile that
    moved was solved to local convergence with its halo frozen, and any
    other tile whose halo is unchanged since its last solve is still at
    its fixed point.  So every round moves the tiles it would move if it
    solved them all, and ``local1``, ``last_round`` and the rounds are
    those of solving every tile every round.  The one host sync per round
    reads the moved and the active tile counts; when no tile is active
    the next round would move nothing, and it is counted without running.
    Each call appends its tiles solved per round to ``SOLVED_TILES``.

    The state starts at ``sub0`` (the adaptive path's ordered-space
    seed, int32 or int64) or, without it, at int32 zeros (the subbin
    lane).  Cells outside every field read the lane's neutral value:
    0 for subbins, ``iinfo.min`` for an ordered state, the signed twin of
    the reference's unsigned 0.

    Returns (interiors (C, *t) in the state's dtype, local1 (C,) sweeps
    of the first local solve, last_round (C,) the last round in which the
    tile moved, rounds run).
    """
    c = flags.shape[0]
    n = c if n_real is None else n_real
    halo_shape = tuple(idx.shape[1:])
    idx2, mask2 = idx.reshape(c, -1), mask.reshape(c, -1)
    if sub0 is None:
        cur = torch.zeros(flags.shape, dtype=torch.int32, device=flags.device)
        fill = 0
    else:
        cur = sub0.clone()
        fill = torch.iinfo(sub0.dtype).min
    cur_flat = cur.reshape(-1)
    last_round = torch.zeros((c,), dtype=torch.int32, device=flags.device)
    local1 = torch.zeros((c,), dtype=torch.int32, device=flags.device)
    dst, src = adjacency
    active = None  # round 1: every real tile
    solved = []
    rnd = 1
    while rnd <= max_rounds:
        if active is None:
            sel = slice(0, n)
            ix, mk, fl = idx2[:n], mask2[:n], flags[:n]
        else:
            sel = active
            ix, mk, fl = idx2[active], mask2[active], flags[active]
        m = fl.shape[0]
        haloed = torch.where(mk, cur_flat.index_select(0, ix.reshape(-1))
                             .reshape(m, -1), fill)
        new, iters = solve_tiles_blockwise(haloed.reshape((m,) + halo_shape),
                                           fl)
        ch_t = (new != cur[sel]).reshape(m, -1).any(dim=1)
        if rnd == 1:
            local1[:n] = iters
        cur[sel] = new
        moved = torch.zeros((c,), dtype=torch.bool, device=flags.device)
        moved[sel] = ch_t
        last_round = torch.where(moved, rnd, last_round)
        hits = torch.zeros((c,), dtype=torch.int32, device=flags.device)
        hits.index_add_(0, dst, moved[src].to(torch.int32))
        nxt = hits > 0
        solved.append(m)
        n_moved, n_next = torch.stack([moved.sum(), nxt.sum()]).tolist()
        if not n_moved:
            break
        rnd += 1
        if not n_next:
            break
        # the active tiles in index order (a stable sort puts them first)
        active = torch.argsort((~nxt).to(torch.uint8), stable=True)[:n_next]
    SOLVED_TILES.append(solved)
    return cur, local1, last_round, min(rnd, max_rounds)


# ------------------------------------------- adaptive-eb ordered-space path
#
# With per-tile eb ladders, neighbouring tiles quantize at different eps,
# so the relative subbin count cannot express cross-eps constraints.  The
# adaptive path solves in absolute ordered space: a cell's state is the
# ordered int of its decoded value, seeded at its bin's decode base, and
# every in-field SoS-less Freudenthal pair carries a constraint
# (``topology.order_flags_all``).  The stored subbin is the ordered
# distance climbed, which the unchanged decode inverts.  The reference
# carries the state biased and unsigned; the port carries its signed
# twin, the ordered int itself (see ``kernels.subbin_sweep``).

def resident_frontend_adaptive(x_h: torch.Tensor, eps: torch.Tensor,
                               dtype: torch.dtype):
    """Quantize at per-tile eps, seed the ordered-space state at each
    cell's decode base, and take the all-pairs flags, over one resident
    batch.  Returns (bins_enc (C, *t) with 0 at invalid cells, s_init
    (C, *t) ordered ints with ``iinfo.min`` at invalid cells, flags
    (C, *t) int32)."""
    capacity = x_h.shape[0]
    valid_h = torch.isfinite(x_h)
    x0 = torch.where(valid_h, x_h, torch.zeros((), dtype=x_h.dtype,
                                                device=x_h.device))
    eps_b = eps[:, None, None, None]
    bins_h = quantize_broadcast(x0, eps_b, dtype)
    valid = _interior(valid_h)
    bins_enc = torch.where(valid, _interior(bins_h), 0)
    s_init = float_to_ordered(decode_base(_interior(bins_h), eps_b, dtype))
    s_init = torch.where(valid, s_init, torch.iinfo(s_init.dtype).min)
    vals_m = _merge(torch.where(valid_h, x0, float("inf")))
    flags = _split_interior(topology.order_flags_all(vals_m), capacity)
    return bins_enc, s_init.contiguous(), flags.contiguous()


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


def resident_decode_plain(bitmap, packed, eps, tile_elems: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """Decode a tile batch without a subbin stream (preserve_order=False)
    -> (C, tile_elems) values: kernel 3's no-subbin instantiation."""
    return decode_tiles_fused(bitmap, packed, None, None, eps, tile_elems,
                              dtype)


def resident_encode_fused(x_h: torch.Tensor, eps: torch.Tensor,
                          dtype: torch.dtype, bins_store: torch.dtype,
                          bins_chunk: int):
    """The plain f32 compress as one kernel over the haloed tile batch:
    the interiors are sliced out here into a contiguous (C, tile_elems)
    copy on the device (the reference's ``_interior`` reshape; for 1-D
    and 2-D tiles a reshape alone can leave a strided view), then
    quantize -> delta/zigzag -> BIT -> RZE bitmap in
    ``encode_values_fused``."""
    x_int = _interior(x_h).reshape(x_h.shape[0], -1).contiguous()
    return encode_values_fused(x_int, eps, bins_chunk, dtype, bins_store)


# --------------------------------------------- temporal chain stages
#
# Frame chains (``repro_torch.temporal``) predict frame t's bins from the
# previous frame's bins, which stay on the device between frames.  The
# reference runs these four stages as XLA programs outside any Pallas
# kernel; here they are torch ops on the chain's device.

def residual_tiles(bins_enc: torch.Tensor, prev_bins: torch.Tensor) -> torch.Tensor:
    """Temporal bin residual of one resident frame batch against the
    previous frame's bins, wrapping in the bin dtype."""
    return bins_enc - prev_bins


def accumulate_bins(prev_bins: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Decode-side inverse of :func:`residual_tiles`."""
    return prev_bins + residual.to(prev_bins.dtype)


def decode_tiles(bitmap: torch.Tensor, packed: torch.Tensor, tile_elems: int,
                 transform: str, out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of the integer encode over (C*cpt) section rows -> (C,
    tile_elems) ints: decoded in the words' W-bit signed twin, then cast
    to ``out_dtype``, which sign-extends a narrowed stream as the
    reference's ``astype`` does."""
    cpt = -(-tile_elems // packed.shape[1])
    ints = expand_ints(bitmap, packed, packed.shape[0] // cpt, tile_elems,
                       transform)
    return ints.to(out_dtype)


def _front_pack(flat: torch.Tensor, live: torch.Tensor):
    """Live entries of ``flat`` front-packed in order and zeros after
    them, by one unique-index scatter (no host sync) -> (dense, total)."""
    idt = torch.int32 if flat.numel() < 2**31 else torch.int64
    cum = torch.cumsum(live, 0, dtype=idt)
    total = cum[-1]
    cum_dead = torch.cumsum(~live, 0, dtype=idt)
    dest = torch.where(live, cum - 1, total + cum_dead - 1)
    dense = torch.zeros_like(flat).scatter_(0, dest.long(),
                                            torch.where(live, flat, 0))
    return dense, total


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """A bool vector (length a multiple of 8) packed MSB-first to uint8,
    as ``np.packbits``."""
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=mask.device)
    return (mask.reshape(-1, 8).to(torch.int32) * weights).sum(1).to(torch.uint8)


def _zero_bytes_out(dense: torch.Tensor):
    """Byte-level zero elimination of a word buffer (the container's
    final RZE_1 stage, as a transport): -> (nonzero-byte mask packed
    MSB-first, the nonzero bytes front-packed, their count).  Bytes are
    the words' little-endian bytes, as the host's ``view(np.uint8)``."""
    b = dense.view(torch.uint8)
    live = b != 0
    nz, total = _front_pack(b, live)
    return _pack_bits(live), nz, total


def compact_streams(bitmap: torch.Tensor, words: torch.Tensor):
    """Device-side compaction of one encoded stream for the download.

    Returns ``(keepmap, kept, words, totals)``:

    - ``words = (dense, mask, nz)``: ``dense`` holds every nonzero word
      of ``words`` front-packed in row-major order (row-major global
      order equals per-row compaction concatenated); ``mask``/``nz`` are
      the same run with its zero bytes eliminated (nonzero-byte mask
      packed MSB-first, nonzero bytes front-packed);
    - ``keepmap`` and ``kept = (dense, mask, nz)``: the bitmap words that
      differ from their predecessor (repeat elimination) and their keep
      mask packed MSB-first as uint8, the kept run also in its
      zero-byte-eliminated form;
    - ``totals``: (nonzero words, kept bitmap words, nonzero bytes of
      the word run, nonzero bytes of the kept run) int64, the one small
      fetch that sizes the real download and picks, per run, the
      smaller of the word and the byte form.

    The reference compacts at word level only; the byte level mirrors
    the container's own final byte-level RZE, without which words with
    zero bytes (small deltas of smooth fields) travel at up to twice
    their serialized size.  Words are signed twins: ``!= 0`` and the
    repeat test compare bit patterns, so both levels are exact.  Per-row
    counts are not sent: they are the bitmap rows' popcounts.
    """
    flat_w = words.reshape(-1)
    words_dense, total_words = _front_pack(flat_w, flat_w != 0)
    flat_b = bitmap.reshape(-1)
    keep = torch.ones_like(flat_b, dtype=torch.bool)
    keep[1:] = flat_b[1:] != flat_b[:-1]
    kept_dense, total_kept = _front_pack(flat_b, keep)
    kept_mask, kept_nz, nz_kept = _zero_bytes_out(kept_dense)
    words_mask, words_nz, nz_words = _zero_bytes_out(words_dense)
    totals = torch.stack([t.to(torch.int64) for t in
                          (total_words, total_kept, nz_words, nz_kept)])
    return (_pack_bits(keep), (kept_dense, kept_mask, kept_nz),
            (words_dense, words_mask, words_nz), totals)
