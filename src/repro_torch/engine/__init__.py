"""Tiled, batched, device-resident compression engine (port of
``repro.engine``).

    blob = compress(field, eb=1e-2)                        # on the CUDA device
    out  = decompress(blob)
    blob = compress(field, eb=1e-2, preserve_order=False)  # plain path
    blob = compress(field, eb=1e-2, adaptive_eb="tda")     # per-tile eb ladder
    box  = decompress_roi(blob, (slice(0, 8), slice(4, 20), slice(None)))
    blob = compress(field, eb=1e-2, device="cpu")          # plain versions

``executor.TRANSFER_COUNTS`` counts host<->device crossings,
``executor.DECODE_COUNTS`` the decoded tiles and batches, and
``repro_torch.kernels.LAUNCHES`` the kernel launches.
"""
from .engine import (
    ADAPTIVE_EB_MODES,
    CompressStats,
    assemble_interiors,
    compress,
    compress_many,
    container_layout,
    decode_nonfinite_region,
    decode_tiles_for_region,
    decode_tiles_many,
    decompress,
    decompress_many,
    decompress_roi,
    region_from_tiles,
    resolve_device,
)
from .executor import Executor
from .plan import CompressionPlan, TileLayout, tiles_for_region
from . import device, executor, halo

__all__ = [
    "ADAPTIVE_EB_MODES",
    "CompressionPlan",
    "CompressStats",
    "Executor",
    "TileLayout",
    "assemble_interiors",
    "compress",
    "compress_many",
    "container_layout",
    "decode_nonfinite_region",
    "decode_tiles_for_region",
    "decode_tiles_many",
    "decompress",
    "decompress_many",
    "decompress_roi",
    "region_from_tiles",
    "resolve_device",
    "tiles_for_region",
    "device",
    "executor",
    "halo",
]
