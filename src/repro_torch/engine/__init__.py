"""Tiled, batched, device-resident compression engine (port of
``repro.engine``).

    blob = compress(field, eb=1e-2)            # on the CUDA device
    out  = decompress(blob)
    blob = compress(field, eb=1e-2, device="cpu")  # plain versions

``executor.TRANSFER_COUNTS`` counts host<->device crossings and
``repro_torch.kernels.LAUNCHES`` the kernel launches.
"""
from .engine import (
    CompressStats,
    compress,
    compress_many,
    container_layout,
    decompress,
    decompress_many,
    resolve_device,
)
from .executor import Executor
from .plan import CompressionPlan, TileLayout
from . import device, executor, halo

__all__ = [
    "CompressionPlan",
    "CompressStats",
    "Executor",
    "TileLayout",
    "compress",
    "compress_many",
    "container_layout",
    "decompress",
    "decompress_many",
    "resolve_device",
    "device",
    "executor",
    "halo",
]
