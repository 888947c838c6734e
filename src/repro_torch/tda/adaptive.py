"""Topology-adaptive per-tile error bounds (port of
``repro.tda.adaptive``).

Each tile of a field gets a rung of the eb ladder ``{eb_user *
2**(k_max - k), k in 0..k_max}`` (rung ``k_max`` is the user bound,
rung 0 is ``2**k_max`` times looser), stored per tile in the container
(``core.bitstream``, TAG_EB_LADDER):

- *noise-dominated* tiles (critical-cell density >= DENSE_TOPOLOGY) may
  loosen to ``NOISE_FRACTION`` of their noise scale (the median absolute
  second difference);
- *featureless* tiles (no critical cell) to ``RELIEF_FRACTION`` of their
  relief;
- tiles with *sparse* criticality to half of that.

Each doubling of a tile's floor over the user bound loosens one rung.
A final pass (``tighten_ladder``) re-runs the exact quantize and
decode-base arithmetic and tightens any tile whose looser grid would put
a decode anchor on the wrong side of a neighbouring tile's anchor.

The ladder is part of the container, so it must equal the reference's
rung for rung.  The field-wide passes run as torch ops on the field's
device, where they are exact (integer and boolean work, min/max, the
second differences and their per-tile order statistics, the quantize
anchors); the per-tile arithmetic on the n_tiles results (the median of
the two middle values, the floors, ``floor(log2(.))``) stays in numpy
float64, as in the reference, whose ``np.nanmedian`` averages the two
middle values where ``torch.nanmedian`` returns the lower one.

Fields are tensors (scored on their own device) or numpy arrays
(uploaded to ``device``, the CUDA device unless the caller passes
``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitstream import EB_LADDER_K_MAX
from ..core.quantize import decode_base, effective_eps, quantize_broadcast
from ..core.topology import offsets
from .critpoints import CLASS_REGULAR, _tensor, classify_critical_points

ADAPTIVE_EB_MODES = ("off", "tda")

# Critical-cell density at or above which a tile's topology is treated
# as noise-dominated.
DENSE_TOPOLOGY = 0.02
# Noise-dominated tiles: eps may grow to this fraction of the tile's
# noise scale.
NOISE_FRACTION = 0.6
# Featureless tiles: eps may grow to this fraction of the tile relief.
RELIEF_FRACTION = 1.0 / 16.0
# Tiles holding sparse persistent criticals: half the featureless
# allowance.
CRITICAL_RELIEF_FRACTION = RELIEF_FRACTION / 2.0


def tile_ids(layout, device) -> torch.Tensor:
    """(canonical) int64: row-major tile id of every real cell."""
    g, t = layout.grid, layout.tile
    c = layout.canonical
    i0 = torch.arange(c[0], device=device) // t[0]
    i1 = torch.arange(c[1], device=device) // t[1]
    i2 = torch.arange(c[2], device=device) // t[2]
    return (i0[:, None, None] * g[1] + i1[None, :, None]) * g[2] \
        + i2[None, None, :]


def _tile_blocks(vol: torch.Tensor, layout) -> torch.Tensor:
    """(n_tiles, -1) view of ``vol`` (leading-dim stack over the canonical
    shape), NaN-padded so partial edge tiles pool only real cells."""
    lead = vol.shape[0]
    g, t = layout.grid, layout.tile
    c = layout.canonical
    pad = torch.full((lead,) + tuple(layout.padded), float("nan"),
                     dtype=vol.dtype, device=vol.device)
    pad[:, : c[0], : c[1], : c[2]] = vol
    b = pad.reshape(lead, g[0], t[0], g[1], t[1], g[2], t[2])
    return b.permute(1, 3, 5, 0, 2, 4, 6).reshape(layout.n_tiles, -1)


def tile_relief(x3, layout, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Per-tile (min, max) over real cells, row-major grid order, as
    float64 arrays.  ``x3`` is the canonical 3-D view of the field."""
    blocks = _tile_blocks(_tensor(x3, device).to(torch.float64)[None], layout)
    nan = torch.isnan(blocks)
    tmin = torch.where(nan, float("inf"), blocks).amin(dim=1)
    tmax = torch.where(nan, float("-inf"), blocks).amax(dim=1)
    return tmin.cpu().numpy(), tmax.cpu().numpy()


def tile_noise_scale(x3, layout, device="cuda") -> np.ndarray:
    """Per-tile noise scale: median |second difference| pooled over all
    axes (0 where a tile has none).  The middle values are selected on
    the device; their mean, as ``np.nanmedian`` takes it, in numpy."""
    x3 = _tensor(x3, device).to(torch.float64)
    c = layout.canonical
    d2 = torch.full((3,) + tuple(c), float("nan"), dtype=torch.float64,
                    device=x3.device)
    for ax in range(3):
        if c[ax] >= 3:
            sl = [slice(None)] * 3
            sl[ax] = slice(1, c[ax] - 1)
            d2[(ax, *sl)] = torch.diff(x3, n=2, dim=ax).abs()
    blocks = _tile_blocks(d2, layout)
    nan = torch.isnan(blocks)
    n = (~nan).sum(dim=1)
    ordered = torch.where(nan, float("inf"), blocks).sort(dim=1).values
    lo_i = torch.clamp((n - 1) // 2, min=0)
    hi_i = torch.clamp(n // 2, max=blocks.shape[1] - 1)
    lo = ordered.gather(1, lo_i[:, None])[:, 0].cpu().numpy()
    hi = ordered.gather(1, hi_i[:, None])[:, 0].cpu().numpy()
    n = n.cpu().numpy()
    # np.nanmedian: rows of >= 600 values take np.median (an odd count's
    # middle value as it is), shorter rows np.ma.median ((a + a) / 2)
    med = (lo + hi) / 2.0
    if blocks.shape[1] >= 600:
        med = np.where(n % 2 == 1, lo, med)
    return np.nan_to_num(np.where(n == 0, np.nan, med))


def critical_counts(x, layout, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Per-tile (critical-cell count, real-cell count).  The census runs
    on the field at its own dtype and rank, as the reference's does."""
    x = _tensor(x, device)
    cls = classify_critical_points(x)
    crit3 = (cls != CLASS_REGULAR).reshape(layout.canonical)
    tid = tile_ids(layout, x.device)
    counts = torch.bincount(tid[crit3], minlength=layout.n_tiles)
    cells = torch.bincount(tid.reshape(-1), minlength=layout.n_tiles)
    return counts.cpu().numpy(), cells.cpu().numpy()


def critical_tiles(x, layout, device="cuda") -> np.ndarray:
    """(n_tiles,) bool: does the tile contain any critical cell?"""
    counts, _ = critical_counts(x, layout, device)
    return counts > 0


def _boundary_violation_tiles(base, x3, eps_cell, tid, n_tiles: int):
    """Tiles whose looser grid breaks SoS anchor order at a boundary.

    For every Freudenthal neighbour pair straddling tiles of different
    eps, the decode anchors must not be ordered against the values, and
    exact value ties must share an anchor.  Returns a bool mask over
    tiles: for each offending pair, the looser side."""
    tighten = torch.zeros(n_tiles, dtype=torch.bool, device=x3.device)
    offs = offsets(3)
    for off in offs[: len(offs) // 2]:  # each unordered pair once
        sa = tuple(slice(None) if d == 0
                   else (slice(None, -d) if d > 0 else slice(-d, None))
                   for d in off)
        sb = tuple(slice(None) if d == 0
                   else (slice(d, None) if d > 0 else slice(None, d))
                   for d in off)
        ea, eb_ = eps_cell[sa], eps_cell[sb]
        cross = ea != eb_
        xa, xb = x3[sa], x3[sb]
        ba, bb = base[sa], base[sb]
        viol = cross & (((xa < xb) & (ba > bb)) | ((xa > xb) & (ba < bb))
                        | ((xa == xb) & (ba != bb)))
        loose_tid = torch.where(ea > eb_, tid[sa], tid[sb])[viol]
        tighten[loose_tid] = True
    return tighten


def tighten_ladder(x, layout, ladder: np.ndarray, eps_abs: float,
                   k_max: int = EB_LADDER_K_MAX, device="cuda") -> np.ndarray:
    """Raise rungs until no cross-eps tile boundary inverts anchors.

    ``eps_abs`` is the user's absolute bound (the tightest rung).  Runs
    the device pipeline's own quantize and decode-base arithmetic, so "no
    violation" here is "no violation" there.  Monotone (never loosens)
    and convergent: all-equal rungs have no cross-eps pairs."""
    ladder = np.asarray(ladder, np.uint8).copy()
    x3 = _tensor(x, device).reshape(layout.canonical).contiguous()
    tid = tile_ids(layout, x3.device)
    eps_tight = effective_eps(eps_abs)
    for _ in range(k_max + 1):
        if (ladder == ladder[0]).all():
            break
        eps_tiles = eps_tight * np.exp2(k_max - ladder.astype(np.float64))
        eps_cell = torch.from_numpy(eps_tiles).to(x3.device)[tid]
        bins = quantize_broadcast(x3, eps_cell, x3.dtype)
        base = decode_base(bins, eps_cell, x3.dtype)
        tighten = _boundary_violation_tiles(base, x3, eps_cell, tid,
                                            layout.n_tiles).cpu().numpy()
        tighten &= ladder < k_max
        if not tighten.any():
            break
        ladder[tighten] += 1
    return ladder


def ladder_indices(x, layout, eps_abs: float, k_max: int = EB_LADDER_K_MAX,
                   device="cuda") -> np.ndarray:
    """(n_tiles,) uint8 eb-ladder index per tile (k_max = tightest).

    ``eps_abs`` is the user's absolute bound, rung ``k_max`` exactly.
    Constant fields take rung 0 everywhere.
    """
    x = _tensor(x, device)
    if not bool(torch.isfinite(x).all()):
        raise ValueError("adaptive-eb scoring requires a finite field "
                         "(strip non-finite cells first)")
    x3 = x.to(torch.float64).reshape(layout.canonical)
    rng = float(x3.max()) - float(x3.min())
    idx = np.zeros(layout.n_tiles, np.uint8)
    if rng == 0.0 or k_max == 0:
        return idx
    tmin, tmax = tile_relief(x3, layout)
    counts, cells = critical_counts(x, layout)
    sigma = tile_noise_scale(x3, layout)

    relief = tmax - tmin
    dense = counts >= DENSE_TOPOLOGY * cells
    flat = counts == 0
    floor = np.where(flat, RELIEF_FRACTION * relief,
                     CRITICAL_RELIEF_FRACTION * relief)
    floor[dense] = np.maximum(floor[dense], NOISE_FRACTION * sigma[dense])

    loose = np.zeros(layout.n_tiles, np.int64)
    grows = floor > float(eps_abs)
    loose[grows] = np.clip(
        np.floor(np.log2(floor[grows] / float(eps_abs))).astype(np.int64),
        0, k_max)
    idx[:] = (k_max - loose).astype(np.uint8)
    return tighten_ladder(x, layout, idx, eps_abs, k_max)
