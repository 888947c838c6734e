"""Numerical core of the port: float bit maps, quantization, topology,
the subbin fixed point, the container format, the non-finite sidecar and
the single-field API (``compress``, ``decompress``)."""
from .lopc import CompressStats, compress, compression_ratio, decompress

__all__ = ["compress", "decompress", "compression_ratio", "CompressStats"]
