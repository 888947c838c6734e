"""RZE_w — repeated-zero elimination (port of ``repro.codecs.rze``).

Per chunk: an MSB-first bitmap marks nonzero words.  The device half
produces the bitmap and the per-chunk counts (:func:`rze_bitmap`),
front-packs the nonzero words (:func:`rze_compact`; both together are
:func:`rze_encode`) and expands front-packed words back
(:func:`rze_decode`); the host half (``np_*``) serves the container
serializer.
"""
from __future__ import annotations

import numpy as np
import torch

from .transforms import width


def rze_bitmap(words: torch.Tensor):
    """(C, L) W-bit words -> (bitmap (C, L//W) words, counts (C,) int32)."""
    dt = words.dtype
    w = width(dt)
    n_chunks, length = words.shape
    assert length % w == 0
    nz = words != 0
    counts = torch.sum(nz, dim=1).to(torch.int32)
    shifts = torch.arange(w - 1, -1, -1, dtype=dt, device=words.device)
    grouped = nz.to(dt).reshape(n_chunks, length // w, w)
    bitmap = torch.sum(grouped << shifts, dim=-1).to(dt)
    return bitmap, counts


def rze_compact(words: torch.Tensor) -> torch.Tensor:
    """(C, L) words -> (C, L) with each chunk's nonzero words front-packed
    in order and zeros after them.

    Stable compaction without a sort, as the reference does it: a nonzero
    word's destination is its inclusive prefix count - 1; zero words go
    (as zeros) to the unique slots past the count, so one scatter with
    unique indices fills every slot.
    """
    nz = words != 0
    cum_nz = torch.cumsum(nz, dim=1, dtype=torch.int32)
    cum_z = torch.cumsum(~nz, dim=1, dtype=torch.int32)
    dest = torch.where(nz, cum_nz - 1, cum_nz[:, -1:] + cum_z - 1)
    return torch.zeros_like(words).scatter_(1, dest.long(), words)


def rze_encode(words: torch.Tensor):
    """(C, L) W-bit words -> (bitmap (C, L//W), packed (C, L), counts (C,)
    int32): ``packed[c, :counts[c]]`` are chunk c's nonzero words in
    order."""
    bitmap, counts = rze_bitmap(words)
    return bitmap, rze_compact(words), counts


def rze_decode(bitmap: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Inverse: scatter front-packed words back to their bitmap positions."""
    dt = packed.dtype
    w = width(dt)
    n_chunks, length = packed.shape
    shifts = torch.arange(w - 1, -1, -1, dtype=dt, device=packed.device)
    bits = (bitmap[:, :, None] >> shifts) & 1
    nz = bits.reshape(n_chunks, length) != 0
    pos = torch.cumsum(nz, dim=1) - 1  # index into packed for each nz slot
    gathered = torch.gather(packed, 1, pos.clamp(min=0))
    return torch.where(nz, gathered, torch.zeros_like(gathered))


# ---------------------------------------------------------------- host side

def np_rze_bytes(stream: np.ndarray):
    """RZE_1: byte-granularity zero elimination on a host byte stream."""
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    nz = stream != 0
    bitmap = np.packbits(nz)  # MSB-first
    return bitmap, stream[nz]


def np_unrze_bytes(bitmap: np.ndarray, nonzero: np.ndarray, n: int) -> np.ndarray:
    nz = np.unpackbits(np.ascontiguousarray(bitmap, np.uint8), count=n).astype(bool)
    out = np.zeros(n, np.uint8)
    out[nz] = nonzero
    return out


def np_repeat_eliminate(words: np.ndarray):
    """Repeat-word elimination for bitmap streams."""
    words = np.ascontiguousarray(words)
    if words.size == 0:
        return np.packbits(np.zeros(0, bool)), words
    keep = np.ones(words.shape[0], bool)
    keep[1:] = words[1:] != words[:-1]
    return np.packbits(keep), words[keep]


def np_repeat_restore(keepmap: np.ndarray, kept: np.ndarray, n: int, dtype) -> np.ndarray:
    keep = np.unpackbits(np.ascontiguousarray(keepmap, np.uint8), count=n).astype(bool)
    idx = np.cumsum(keep) - 1
    return np.ascontiguousarray(kept, dtype)[idx] if n else np.zeros(0, dtype)
