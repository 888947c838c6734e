"""Persistent tile-addressable array store over LOPC containers (port
of ``repro.store``).

    from repro_torch.store import LopcStore

    store = LopcStore.create("run42.lopcstore",
                             plan=CompressionPlan(tile_shape=(16, 16, 64)))
    store.write("density", field, eb=1e-2)
    roi = store.read_roi("density", (slice(0, 8), slice(0, 8), slice(0, 8)))

    store.write_chain("evolution", frames, eb=1e-2, mode="abs")
    store.append_frame("evolution", next_frame)   # byte-identical to a
    frame = store.read_frame("evolution", 3)      # whole-chain compress

    store = LopcStore.open("run42.lopcstore", device="cpu")  # plain versions

``read_roi`` fetches and decodes only the tiles overlapping the region
(positional reads into the payload file: the full blob is never
loaded) and keeps decoded interiors in a bounded LRU keyed by content
crc, so hot-region reads skip the decode while staying byte-identical
to cold ones.  Manifests and payloads equal the reference's byte for
byte (docs/store.md describes the on-disk layout).
"""
from .cache import DEFAULT_CACHE_BYTES, TileCache
from .store import MANIFEST_NAME, STORE_FORMAT, STORE_VERSION, LopcStore

__all__ = [
    "DEFAULT_CACHE_BYTES",
    "LopcStore",
    "MANIFEST_NAME",
    "STORE_FORMAT",
    "STORE_VERSION",
    "TileCache",
]
