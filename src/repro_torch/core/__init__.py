"""Numerical core of the port: float bit maps, quantization, topology,
the subbin fixed point, the container format, the non-finite sidecar and
the single-field API (``compress``, ``decompress``)."""
__all__ = ["compress", "decompress", "compression_ratio", "CompressStats"]


def __getattr__(name: str):
    # lazy, so that importing a leaf module (``core.floatbits``) does not
    # import the compressor and, through it, the kernels that import that
    # leaf
    if name in __all__:
        from . import lopc

        return getattr(lopc, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
