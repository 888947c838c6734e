"""Compression plans (a numpy copy of ``repro.engine.plan``): how an
arbitrary field maps onto fixed-shape tiles.

The engine's central trick is that LOPC's local-order formulation is
*tile-decomposable*: quantization is elementwise, order flags only look
one cell away, and the subbin fixed point is the least solution of a
monotone system — so it can be computed by tile-local solves plus
one-cell halo exchange and still land on exactly the global answer
(see docs/engine.md).  A ``CompressionPlan`` therefore reduces every
1/2/3-D field to batches of one fixed canonical-3D tile shape, and every
device program is traced once per (tile_shape, dtype) instead of once
per field shape.

Canonicalization: a k-D field becomes 3-D by prepending unit axes.  On a
(1, H, W) grid the 3-D Freudenthal offsets with a +-1 first component
fall outside the grid (no constraint), and the surviving six offsets are
exactly the 2-D Freudenthal link — so flags, subbins, and the flattened
encode order all coincide with the native k-D computation.

Host-side tile movement is plain numpy (the storage-DMA side of the
engine); everything shape-dependent lives here, nothing shape-dependent
reaches a jit boundary.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

HALO = 1  # one-cell halo: order constraints only couple grid neighbors


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def canonical3d_shape(shape: tuple[int, ...]) -> tuple[int, int, int]:
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"LOPC supports 1D/2D/3D grids, got ndim={len(shape)}")
    return (1,) * (3 - len(shape)) + tuple(int(n) for n in shape)


def auto_tile_shape(canonical: tuple[int, int, int]) -> tuple[int, int, int]:
    """Pick a tile shape for a field when the plan does not fix one.

    Power-of-two extents capped per axis keep the set of distinct tile
    shapes (and hence jit traces) small while bounding pad waste; unit
    leading axes get their budget moved to the trailing axes.
    """
    c0, c1, c2 = canonical
    if c0 == 1 and c1 == 1:
        caps = (1, 1, 4096)
    elif c0 == 1:
        caps = (1, 64, 64)
    else:
        caps = (16, 16, 64)
    return tuple(min(_pow2ceil(c), cap) for c, cap in zip(canonical, caps))


@dataclass(frozen=True)
class TileLayout:
    """Concrete tiling of one field shape under a plan."""

    field_shape: tuple[int, ...]
    canonical: tuple[int, int, int]
    tile: tuple[int, int, int]
    grid: tuple[int, int, int]

    @property
    def n_tiles(self) -> int:
        return int(np.prod(self.grid))

    @property
    def tile_elems(self) -> int:
        return int(np.prod(self.tile))

    @property
    def padded(self) -> tuple[int, int, int]:
        return tuple(g * t for g, t in zip(self.grid, self.tile))

    @property
    def halo_tile(self) -> tuple[int, int, int]:
        return tuple(t + 2 * HALO for t in self.tile)

    def neighbor_index(self):
        """Flat gather table rebuilding haloed tiles from interiors on
        device -> (idx int32, mask bool), both (n_tiles, *halo_tile).
        See engine/halo.py; cached per layout."""
        from . import halo  # lazy: halo imports this module

        return halo.neighbor_index(self)


@dataclass(frozen=True)
class CompressionPlan:
    """Plan half of the plan/execute engine.

    ``tile_shape`` fixes one canonical-3D tile for every field routed
    through the plan (the shape-stable production configuration);
    ``None`` buckets each field to an auto tile shape (a small bounded
    family — convenient for the single-field convenience API).
    ``batch_tiles`` is the fixed tile-batch extent of every device
    program; tiles from *different* fields and requests share batches.
    """

    tile_shape: tuple[int, int, int] | None = None
    batch_tiles: int = 8

    def __post_init__(self):
        if self.batch_tiles < 1:
            raise ValueError("batch_tiles must be >= 1")
        if self.tile_shape is not None and (
            len(self.tile_shape) != 3 or min(self.tile_shape) < 1
        ):
            raise ValueError(f"tile_shape must be 3 positive ints, got {self.tile_shape}")

    def layout_for(self, field_shape: tuple[int, ...]) -> TileLayout:
        return _layout(self.tile_shape, tuple(field_shape))


def _shrink_tile(tile: tuple[int, int, int],
                 canonical: tuple[int, int, int]) -> tuple[int, int, int]:
    """Fit plan-tile axes to the field: same tile count, less pad.

    The plan tile fixes how many tiles cover each axis (``g = ceil(c/t)``
    — that is the throughput-relevant quantity); within that grid the
    extent is lowered to the field's even cover ``ceil(c/g)``, rounded up
    to a multiple of 4 (lane-friendly, keeps the shape family bounded).
    A 36-cell axis under a 16-tile keeps its 3 tiles but shrinks them to
    12 — cover 36 instead of 48 — and a unit axis of a low-rank field
    collapses to 1, so 2-D fields stop paying for a 3-D plan tile.  Pad
    cells cost real quantize/solve/encode work per tile, so this is the
    difference between a field-sized pipeline and one inflated by up to
    2x (measured on the paper inputs).

    Each distinct shrunk shape is one extra trace, paid once and then
    warm, exactly like the auto-tiling buckets; steady-state serving
    never retraces (the trace probe asserts this).
    """
    out = []
    for c, t in zip(canonical, tile):
        g = -(-c // t)
        even = -(-c // g)
        if even > 1:
            even = min(t, -(-even // 4) * 4)
        out.append(even)
    return tuple(out)


@lru_cache(maxsize=4096)
def _layout(tile_shape, field_shape) -> TileLayout:
    canonical = canonical3d_shape(field_shape)
    if tile_shape is not None:
        tile = _shrink_tile(tile_shape, canonical)
    else:
        tile = auto_tile_shape(canonical)
    grid = tuple(-(-c // t) for c, t in zip(canonical, tile))
    return TileLayout(field_shape, canonical, tile, grid)


# ---------------------------------------------------------- host tile I/O

def padded_with_border(arr3: np.ndarray, layout: TileLayout, fill) -> np.ndarray:
    """Canonical field -> (padded + 2*HALO border) array, `fill` outside."""
    p = layout.padded
    out = np.full(tuple(d + 2 * HALO for d in p), fill, arr3.dtype)
    c = layout.canonical
    out[HALO : HALO + c[0], HALO : HALO + c[1], HALO : HALO + c[2]] = arr3
    return out


def extract_halo_tiles(padded_b: np.ndarray, layout: TileLayout) -> np.ndarray:
    """(padded+border) array -> (n_tiles, *halo_tile), row-major grid order."""
    t = layout.tile
    win = sliding_window_view(padded_b, layout.halo_tile)
    tiles = win[:: t[0], :: t[1], :: t[2]]
    return np.ascontiguousarray(tiles.reshape((layout.n_tiles,) + layout.halo_tile))


def scatter_interiors(tiles: np.ndarray, layout: TileLayout,
                      padded_b: np.ndarray) -> None:
    """Write (n_tiles, *tile) interiors back into a padded+border array."""
    g, t = layout.grid, layout.tile
    blocks = tiles.reshape(g + t).transpose(0, 3, 1, 4, 2, 5)
    p = layout.padded
    padded_b[HALO : HALO + p[0], HALO : HALO + p[1], HALO : HALO + p[2]] = (
        blocks.reshape(p)
    )

