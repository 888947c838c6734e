"""Device-side halo exchange: precomputed neighbor-index tables.

A numpy copy of ``repro.engine.halo`` (the port never imports ``repro``).
Rather than refreshing tile halos on the host between relax rounds, the
solve rebuilds every haloed tile on the device with one gather.

For a :class:`~repro_torch.engine.plan.TileLayout` we precompute, once per
layout, a flat index table ``idx`` and validity mask ``mask`` of shape
``(n_tiles, *halo_tile)`` such that for interiors ``I`` of shape
``(n_tiles, *tile)``::

    haloed = where(mask, I.reshape(-1)[idx], 0)

reproduces exactly what host-side ``scatter_interiors`` +
``extract_halo_tiles`` produce: interior cells map to themselves, halo
cells map to the adjacent tile's interior, and cells beyond the padded
field are masked to 0.
One gather per relax round, no host involvement.

Group tables: a compress group holds the concatenated tiles of several
fields.  Fields are independent (halos never cross fields), so the group
table is each field's table shifted by its tile offset, padded with
masked rows up to the group's resident capacity.  Tables depend only on
(layout sequence, capacity), so steady-state serving reuses them from an
LRU cache — they are plan constants, not per-request data.

Index dtype is int32: a resident group would need > 2^31 interior cells
before overflow (≈ 8 GiB of int32 subbins), far beyond a sane resident
set; guarded by an explicit check.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .plan import HALO, TileLayout


# Cached tables are field-sized (an int32 index plus a bool mask over
# every haloed cell, ~2x the field's own bytes for f32 data), so the
# caches are kept deliberately small: entry-count eviction cannot bound
# bytes, and a serving process that churns through many distinct large
# field shapes should expect roughly <maxsize> x <largest field> bytes
# of steady-state table residency (call .cache_clear() to drop it).

@lru_cache(maxsize=32)
def neighbor_index(layout: TileLayout) -> tuple[np.ndarray, np.ndarray]:
    """-> (idx int32, mask bool), both shaped (n_tiles, *halo_tile).

    ``idx`` indexes the flattened ``(n_tiles, *tile)`` interior array;
    ``mask`` is False where the haloed cell falls outside the padded
    field (reads there must yield the zero border).
    """
    t, g, p = layout.tile, layout.grid, layout.padded
    # Per axis: global padded coordinate of every (grid pos, halo-local)
    # pair, then its (tile grid index, in-tile index) decomposition.
    ax = []
    for a in range(3):
        coord = (np.arange(g[a])[:, None] * t[a] - HALO
                 + np.arange(t[a] + 2 * HALO)[None, :])        # (g_a, h_a)
        valid = (coord >= 0) & (coord < p[a])
        ti, li = np.divmod(np.clip(coord, 0, p[a] - 1), t[a])
        ax.append((ti, li, valid))
    # Broadcast the three axes over (g0, h0, g1, h1, g2, h2).
    ti0 = ax[0][0].reshape(g[0], t[0] + 2, 1, 1, 1, 1)
    li0 = ax[0][1].reshape(g[0], t[0] + 2, 1, 1, 1, 1)
    v0 = ax[0][2].reshape(g[0], t[0] + 2, 1, 1, 1, 1)
    ti1 = ax[1][0].reshape(1, 1, g[1], t[1] + 2, 1, 1)
    li1 = ax[1][1].reshape(1, 1, g[1], t[1] + 2, 1, 1)
    v1 = ax[1][2].reshape(1, 1, g[1], t[1] + 2, 1, 1)
    ti2 = ax[2][0].reshape(1, 1, 1, 1, g[2], t[2] + 2)
    li2 = ax[2][1].reshape(1, 1, 1, 1, g[2], t[2] + 2)
    v2 = ax[2][2].reshape(1, 1, 1, 1, g[2], t[2] + 2)

    tile_id = (ti0 * g[1] + ti1) * g[2] + ti2
    flat = ((tile_id * t[0] + li0) * t[1] + li1) * t[2] + li2
    mask = v0 & v1 & v2
    if layout.n_tiles * layout.tile_elems > np.iinfo(np.int32).max:
        raise ValueError("field too large for an int32 halo index table")
    # (g0, h0, g1, h1, g2, h2) -> (n_tiles, h0, h1, h2)
    order = (0, 2, 4, 1, 3, 5)
    h = layout.halo_tile
    idx = np.ascontiguousarray(
        np.transpose(flat, order).reshape((layout.n_tiles,) + h)
    ).astype(np.int32)
    mask = np.ascontiguousarray(
        np.transpose(np.broadcast_to(mask, flat.shape), order)
        .reshape((layout.n_tiles,) + h)
    )
    return idx, mask


@lru_cache(maxsize=32)
def group_index(layouts: tuple[TileLayout, ...], capacity: int):
    """Concatenated per-field tables padded to ``capacity`` tiles.

    All layouts in a group share one tile shape (the engine groups by
    it); each field's indices are shifted by its tile offset so the
    gather never crosses fields.  Pad rows are fully masked: pad tiles
    read the zero border everywhere, which keeps their subbins at 0.
    """
    tile = layouts[0].tile
    h = layouts[0].halo_tile
    elems = layouts[0].tile_elems
    idxs, masks = [], []
    off = 0
    for lay in layouts:
        if lay.tile != tile:
            raise ValueError("group layouts must share one tile shape")
        idx, mask = lay.neighbor_index()
        idxs.append(idx + np.int64(off) * elems)
        masks.append(mask)
        off += lay.n_tiles
    if off > capacity:
        raise ValueError(f"group of {off} tiles exceeds capacity {capacity}")
    if capacity * elems > np.iinfo(np.int32).max:
        raise ValueError("resident group too large for an int32 index table")
    pad = capacity - off
    if pad:
        idxs.append(np.zeros((pad,) + h, np.int64))
        masks.append(np.zeros((pad,) + h, bool))
    idx = np.ascontiguousarray(np.concatenate(idxs)).astype(np.int32)
    mask = np.ascontiguousarray(np.concatenate(masks))
    return idx, mask
