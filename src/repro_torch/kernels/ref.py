"""Plain PyTorch oracles of the whole-field kernels (port of the parts of
``repro.kernels.ref`` this slice needs).

``canonical3d`` is the 3-D view every whole-field solve runs on;
``bitshuffle_ref`` / ``bitunshuffle_ref`` and ``rze_bitmap_ref`` are the
plain versions of the BIT_4 transpose and the RZE bitmap kernels.  The
FF32 oracles wait for ROADMAP.md kernel queue items 6-7.
"""
from __future__ import annotations

import torch

from ..codecs.bitshuffle import bitshuffle, bitunshuffle
from ..codecs.rze import rze_bitmap


def canonical3d(x: torch.Tensor) -> torch.Tensor:
    """1-D and 2-D fields viewed as 3-D: (n,) -> (n, 1, 1), (a, b) ->
    (a, b, 1).  The Freudenthal 2-D (1-D) link is the 3-D link restricted
    to in-plane offsets, so flags and fixed point agree."""
    if x.dim() == 3:
        return x
    if x.dim() == 2:
        return x[:, :, None]
    return x[:, None, None]


def bitshuffle_ref(words: torch.Tensor) -> torch.Tensor:
    """(C, L) words -> their bit-planes (plain version of BIT_4)."""
    return bitshuffle(words)


def bitunshuffle_ref(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitshuffle_ref`."""
    return bitunshuffle(words)


def rze_bitmap_ref(words: torch.Tensor):
    """(C, L) words -> (MSB-first nonzero bitmap (C, L/W), counts (C,)
    int32): the plain version of the RZE bitmap kernel."""
    return rze_bitmap(words)
