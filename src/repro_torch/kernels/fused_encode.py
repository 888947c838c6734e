"""Fused lossless encode (port of
``repro.kernels.fused_encode.encode_ints_fused``).

(batch, E) signed ints -> per 16 KiB chunk: [delta -> zigzag |
reinterpret] -> BIT_W -> RZE bitmap, as (bitmap (batch*cpt, L/W),
shuffled words (batch*cpt, L), counts (batch*cpt,) int32).  Words travel
in the signed twin of their width.
"""
from __future__ import annotations

import torch

from ..codecs.bitshuffle import bitshuffle
from ..codecs.rze import rze_bitmap
from ..codecs.transforms import delta_encode, width, zigzag_encode
from . import _lib

# index = the kernel's transform code
TRANSFORMS = ("raw", "delta")


def encode_ints_plain(ints: torch.Tensor, chunk_len: int, transform: str):
    """Op-for-op torch version of the Pallas kernel body
    (``_collapse_ints``)."""
    b, e = ints.shape
    n_chunks = -(-e // chunk_len)
    pad = torch.zeros((b, n_chunks * chunk_len - e), dtype=ints.dtype,
                      device=ints.device)
    chunks = torch.cat([ints, pad], dim=1).reshape(b * n_chunks, chunk_len)
    if transform == "delta":
        words = zigzag_encode(delta_encode(chunks))
    elif transform == "raw":
        words = chunks
    else:
        raise ValueError(f"unknown transform {transform!r} (want {TRANSFORMS})")
    shuffled = bitshuffle(words)
    bitmap, counts = rze_bitmap(shuffled)
    return bitmap, shuffled, counts


def encode_ints_fused(ints: torch.Tensor, chunk_len: int, transform: str):
    """Encode a (batch, E) int batch: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if not ints.is_cuda:
        return encode_ints_plain(ints, chunk_len, transform)
    _lib.require_cuda(ints)
    if ints.dtype not in (torch.int16, torch.int32, torch.int64):
        raise ValueError(f"encode_ints_fused takes int16/32/64, got {ints.dtype}")
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform {transform!r} (want {TRANSFORMS})")
    w = width(ints.dtype)
    if ints.dim() != 2 or chunk_len != 131072 // w:
        raise ValueError(f"encode_ints_fused takes (batch, E) ints and "
                         f"16 KiB chunks ({131072 // w} words of {w} bits)")
    b, e = ints.shape
    rows = b * -(-e // chunk_len)
    dev = ints.device
    bitmap = torch.empty((rows, chunk_len // w), dtype=ints.dtype, device=dev)
    words = torch.empty((rows, chunk_len), dtype=ints.dtype, device=dev)
    counts = torch.empty((rows,), dtype=torch.int32, device=dev)
    _lib.call("fused_encode", "lopc_encode_ints", ints, bitmap, words, counts,
              b, e, w, TRANSFORMS.index(transform))
    _lib.LAUNCHES["encode_ints_fused"] += 1
    return bitmap, words, counts
