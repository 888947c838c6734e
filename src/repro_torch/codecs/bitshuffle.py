"""BIT_w — bit-plane transposition (port of ``repro.codecs.bitshuffle``).

Plane b (b = 0 = MSB) of a chunk occupies words [b*L/W, (b+1)*L/W); bit
j of the plane (MSB-first) is bit W-1-b of word j.  Words ride in signed
twins; every bit extraction masks with ``& 1``, so arithmetic shifts give
the logical result.
"""
from __future__ import annotations

import numpy as np
import torch

from .transforms import width


def _pack_weights(dt: torch.dtype, device) -> torch.Tensor:
    w = width(dt)
    return torch.arange(w - 1, -1, -1, dtype=dt, device=device)


def bitshuffle(words: torch.Tensor) -> torch.Tensor:
    """(n_chunks, L) W-bit words -> (n_chunks, L) transposed bit-planes."""
    dt = words.dtype
    w = width(dt)
    n_chunks, length = words.shape
    assert length % w == 0, f"chunk_len {length} must be a multiple of {w}"
    shifts = _pack_weights(dt, words.device)
    planes = []
    for b in range(w):
        bit = (words >> (w - 1 - b)) & 1
        grouped = bit.reshape(n_chunks, length // w, w)
        # distinct powers of two: the (wrapping) sum is their OR
        planes.append(torch.sum(grouped << shifts, dim=-1).to(dt))
    return torch.cat(planes, dim=1)


def bitunshuffle(shuffled: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitshuffle`."""
    dt = shuffled.dtype
    w = width(dt)
    n_chunks, length = shuffled.shape
    assert length % w == 0
    shifts = _pack_weights(dt, shuffled.device)
    words = torch.zeros((n_chunks, length), dtype=dt, device=shuffled.device)
    per = length // w
    for b in range(w):
        plane = shuffled[:, b * per : (b + 1) * per]
        bits = (plane[:, :, None] >> shifts) & 1
        words |= bits.reshape(n_chunks, length) << (w - 1 - b)
    return words


def np_bitshuffle(words: np.ndarray) -> np.ndarray:
    """Host oracle (numpy) over unsigned words."""
    dt = words.dtype
    w = dt.itemsize * 8
    n_chunks, length = words.shape
    be = f">u{dt.itemsize}"
    bits = np.unpackbits(words.astype(be).view(np.uint8).reshape(n_chunks, length, dt.itemsize), axis=-1)
    bits = bits.reshape(n_chunks, length, w).transpose(0, 2, 1)  # (c, plane, j)
    packed = np.packbits(bits.reshape(n_chunks, -1), axis=-1)    # (c, L*itemsize)
    return np.ascontiguousarray(packed).view(be).astype(dt).reshape(n_chunks, length)


def np_bitunshuffle(shuffled: np.ndarray) -> np.ndarray:
    dt = shuffled.dtype
    w = dt.itemsize * 8
    n_chunks, length = shuffled.shape
    be = f">u{dt.itemsize}"
    bits = np.unpackbits(shuffled.astype(be).view(np.uint8).reshape(n_chunks, -1), axis=-1)
    bits = bits.reshape(n_chunks, w, length).transpose(0, 2, 1)  # (c, j, bit)
    packed = np.packbits(bits.reshape(n_chunks, -1), axis=-1)
    return np.ascontiguousarray(packed).view(be).astype(dt).reshape(n_chunks, length)
