"""Consistent-hash placement of tile ranges onto shards (a copy of
``repro.cluster.placement``).

The placement layer answers one question — *which shards hold tile
``t`` of array ``name``?* — deterministically, from nothing but the
cluster geometry (shard count, replication factor), so every router and
every reader computes identical answers with no coordination service.
The spec is normative in docs/cluster.md; this module is its reference
implementation, and the doc's executable examples recompute the hash
arithmetic by hand against :class:`ShardMap`.

Mechanics (all of it):

* the cluster hash :func:`h64` is blake2b with an 8-byte digest,
  big-endian — stable across platforms and Python versions (unlike
  ``hash()``);
* each shard projects ``vnodes`` points onto a 64-bit ring, at
  ``h64(f"shard:{s}:vnode:{v}")``;
* tiles group into **ranges** of ``tiles_per_range`` consecutive
  row-major tile ids (``range_id = tile_id // tiles_per_range``) so
  neighboring tiles usually co-locate and a region read touches few
  shards;
* a range keys the ring at ``h64(f"{name}:range:{range_id}")`` and is
  owned by the first ``n_replicas`` **distinct** shards met walking
  clockwise from the first ring point strictly greater than the key
  (wrapping);
* array-level metadata — the manifest entry, and chains in their
  entirety — lives on the owners of range 0 (:meth:`ShardMap.home`), so
  any array's info is findable by hashing its name alone.

The on-device half of placement is the sharded tile path in
``distributed.compression``: :func:`make_tile_put` lays the engine's
resident tile batches over a process group and is byte-identical to the
single-device path, so a router may compress through it
(``Router(mesh=...)``) and scatter the very same bytes.
"""
from __future__ import annotations

import hashlib
from bisect import bisect_right
from dataclasses import dataclass, field

from ..distributed.compression import compress_fields_sharded  # noqa: F401
from ..distributed.compression import make_tile_put  # noqa: F401

DEFAULT_VNODES = 64
DEFAULT_TILES_PER_RANGE = 8


def h64(key: str) -> int:
    """The cluster hash: first 8 bytes of ``blake2b(key)``, big-endian."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


def range_of(tile_id: int,
             tiles_per_range: int = DEFAULT_TILES_PER_RANGE) -> int:
    """Tile range (the placement unit) a tile id belongs to."""
    return int(tile_id) // int(tiles_per_range)


@dataclass(frozen=True)
class ShardMap:
    """Deterministic tile-range -> replica-set map over ``n_shards``.

    Frozen/hashable: two maps with equal geometry ARE the same map, on
    any machine.  ``owners`` is primary-first; reads try the owners in
    order (failover), writes must land on all of them.
    """

    n_shards: int
    n_replicas: int = 2
    vnodes: int = DEFAULT_VNODES
    tiles_per_range: int = DEFAULT_TILES_PER_RANGE
    _ring: tuple = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not 1 <= self.n_replicas <= self.n_shards:
            raise ValueError(
                f"n_replicas must be in [1, n_shards]; got "
                f"{self.n_replicas} replicas over {self.n_shards} shards"
            )
        if self.vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        if self.tiles_per_range < 1:
            raise ValueError("tiles_per_range must be >= 1")
        pts = []
        for s in range(self.n_shards):
            for v in range(self.vnodes):
                pts.append((h64(f"shard:{s}:vnode:{v}"), s))
        pts.sort()
        object.__setattr__(self, "_ring", tuple(pts))

    def owners(self, name: str, tile_id: int) -> tuple[int, ...]:
        """Replica shard ids for one tile of ``name``, primary first."""
        key = h64(f"{name}:range:{range_of(tile_id, self.tiles_per_range)}")
        ring = self._ring
        # first ring point strictly greater than the key, wrapping; the
        # sentinel shard id (> any real shard) makes bisect skip points
        # exactly at the key
        i = bisect_right(ring, (key, self.n_shards))
        out: list[int] = []
        seen: set[int] = set()
        for k in range(len(ring)):
            s = ring[(i + k) % len(ring)][1]
            if s not in seen:
                seen.add(s)
                out.append(s)
                if len(out) == self.n_replicas:
                    break
        return tuple(out)

    def home(self, name: str) -> tuple[int, ...]:
        """Shards holding ``name``'s array-level metadata (and, for
        chains, the whole chain): the owners of tile range 0."""
        return self.owners(name, 0)

    def split(self, name: str, tile_ids) -> dict[int, list[int]]:
        """Group ``tile_ids`` by primary owner -> {shard: [tile_id]}."""
        out: dict[int, list[int]] = {}
        for t in tile_ids:
            out.setdefault(self.owners(name, t)[0], []).append(int(t))
        return out

    def shard_tiles(self, name: str, n_tiles: int, shard: int) -> list[int]:
        """Every tile of an ``n_tiles`` array whose replica set includes
        ``shard`` — the tile set that shard's sparse container carries."""
        return [t for t in range(n_tiles) if shard in self.owners(name, t)]
