"""Chunk-wise integer transforms (port of ``repro.codecs.transforms``).

Arrays are (n_chunks, chunk_len); words are carried in signed twins (see
the package docstring), so all arithmetic wraps in the word width.

    z(v) = (v << 1) ^ (v >> (W-1))      (arithmetic shift)
"""
from __future__ import annotations

import numpy as np
import torch

NP_UNSIGNED = {2: np.uint16, 4: np.uint32, 8: np.uint64}


def width(dtype: torch.dtype) -> int:
    """Bits of an integer dtype."""
    return torch.iinfo(dtype).bits


def lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of signed-twin words by ``k`` (0 <= k < W)."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (width(x.dtype) - k)) - 1)


def delta_encode(x: torch.Tensor) -> torch.Tensor:
    """Per-chunk delta along the last axis; first element kept verbatim."""
    prev = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    return x - prev


def delta_decode(d: torch.Tensor) -> torch.Tensor:
    """Wrapping prefix sum: ``cumsum`` promotes to int64, and the cast
    back keeps the low bits, which is the modular result."""
    return torch.cumsum(d, dim=-1).to(d.dtype)


def zigzag_encode(v: torch.Tensor) -> torch.Tensor:
    """Signed -> small unsigned code (carried in the same signed dtype)."""
    return (v << 1) ^ (v >> (width(v.dtype) - 1))


def zigzag_decode(z: torch.Tensor) -> torch.Tensor:
    """Unsigned zigzag code -> signed."""
    return lsr(z, 1) ^ (torch.zeros_like(z) - (z & 1))


def chunk(x: torch.Tensor, chunk_len: int) -> tuple[torch.Tensor, int]:
    """Flatten + zero-pad to (n_chunks, chunk_len). Returns (chunks, n_valid)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    n_chunks = -(-n // chunk_len)
    pad = torch.zeros(n_chunks * chunk_len - n, dtype=flat.dtype,
                      device=flat.device)
    return torch.cat([flat, pad]).reshape(n_chunks, chunk_len), n


def unchunk(chunks: torch.Tensor, n_valid: int, shape) -> torch.Tensor:
    return chunks.reshape(-1)[:n_valid].reshape(shape)
