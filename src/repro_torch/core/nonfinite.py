"""Non-finite sidecar (a numpy copy of ``repro.core.lopc``'s
``encode_nonfinite`` / ``decode_nonfinite``).

NaN/Inf cells are replaced by the finite mean for compression and
restored bit-exactly on decode.
"""
from __future__ import annotations

import numpy as np

from . import bitstream


def encode_nonfinite(x: np.ndarray):
    """-> (finite-filled copy of ``x``, sidecar payload bytes)."""
    mask = ~np.isfinite(x)
    finite = x[~mask]
    fill = finite.mean() if finite.size else 0.0
    w = bitstream.Writer()
    packed = np.packbits(mask.reshape(-1))
    w.lp(packed.tobytes())
    w.lp(np.ascontiguousarray(x[mask]).tobytes())  # exact payloads
    filled = x.copy()
    filled[mask] = fill
    return filled, w.getvalue()


def decode_nonfinite(payload: bytes, out: np.ndarray) -> np.ndarray:
    r = bitstream.Reader(payload)
    packed = np.frombuffer(r.lp(), np.uint8)
    vals = np.frombuffer(r.lp(), out.dtype)
    mask = np.unpackbits(packed, count=out.size).astype(bool).reshape(out.shape)
    out = out.copy()
    out[mask] = vals
    return out
