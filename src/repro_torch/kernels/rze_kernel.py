"""RZE bitmap and nonzero counts of 4096-word chunks (port of
``repro.kernels.rze_kernel``).

Bit j of the bitmap (MSB first within each bitmap word) marks word j of
the chunk nonzero.  The compaction of the nonzero words is not part of
the kernel, as on the TPU: ``codecs.rze.rze_compact`` runs it.
"""
from __future__ import annotations

import torch

from . import _lib
from .ref import rze_bitmap_ref

CHUNK = 4096  # 32-bit words per chunk (16 KiB)


def rze_bitmap_u32(words: torch.Tensor):
    """(C, 4096) int32 words -> (bitmap (C, 128) int32, counts (C,)
    int32): the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if not words.is_cuda:
        return rze_bitmap_ref(words)
    _lib.require_cuda(words)
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != CHUNK:
        raise ValueError(f"rze_bitmap_u32 takes (C, {CHUNK}) int32 words")
    c = words.shape[0]
    bitmap = torch.empty((c, CHUNK // 32), dtype=torch.int32, device=words.device)
    counts = torch.empty((c,), dtype=torch.int32, device=words.device)
    if c:
        _lib.call("rze", "lopc_rze_bitmap", words, bitmap, counts, c)
        _lib.LAUNCHES.add("rze_bitmap_u32")
    return bitmap, counts
