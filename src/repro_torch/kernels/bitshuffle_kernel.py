"""BIT_4 bit-plane transpose of 4096-word chunks (port of
``repro.kernels.bitshuffle_kernel``).

Plane b (b = 0 is the MSB) of a chunk holds bit 31-b of every word, in
words [128b, 128b + 128); plane word g holds words 32g .. 32g+31, word
32g+i at bit 31-i.  Words travel in int32 (the signed twin of uint32).
"""
from __future__ import annotations

import torch

from . import _lib
from .ref import bitshuffle_ref, bitunshuffle_ref

CHUNK = 4096  # 32-bit words per chunk (16 KiB)


def _launch(words: torch.Tensor, inverse: int, name: str) -> torch.Tensor:
    _lib.require_cuda(words)
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != CHUNK:
        raise ValueError(f"{name} takes (C, {CHUNK}) int32 words")
    out = torch.empty_like(words)
    if words.shape[0]:
        _lib.call("bitshuffle", "lopc_bitshuffle", words, out, words.shape[0],
                  inverse)
        _lib.LAUNCHES[name] += 1
    return out


def bitshuffle_u32(words: torch.Tensor) -> torch.Tensor:
    """(C, 4096) int32 words -> their bit-planes: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if not words.is_cuda:
        return bitshuffle_ref(words)
    return _launch(words, 0, "bitshuffle_u32")


def bitunshuffle_u32(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitshuffle_u32`."""
    if not words.is_cuda:
        return bitunshuffle_ref(words)
    return _launch(words, 1, "bitunshuffle_u32")
