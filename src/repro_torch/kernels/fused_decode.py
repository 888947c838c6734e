"""Fused ordered decode (port of
``repro.kernels.fused_decode.decode_tiles_fused``).

RZE expand -> BIT_W un-transpose -> dezigzag + wrapping prefix sum
(bins) or raw (subbins) -> ``decode_base`` with the per-tile eps -> the
ordered-int subbin add.  Covers f32 and f64 outputs and every stream
word width.  Without a subbin stream (``sub_bitmap = sub_packed =
None``, the plain path's containers) the subbin is 0 and the kernel's
no-subbin instantiation runs.

``dequantize_ff32`` (port of ``repro.kernels.fused_decode.dequantize_ff32``)
is the FF32 contract's decode: ``base = (f32(b) - 0.5) * eps32``, plus the
subbin in int32 ordered space, back to f32, as one elementwise kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..codecs.bitshuffle import bitunshuffle
from ..codecs.rze import rze_decode
from ..codecs.transforms import delta_decode, width, zigzag_decode
from ..core.quantize import dequantize_tiles
from . import _lib
from .fused_encode import TRANSFORMS
from .ref import dequantize_ff32_ref


def expand_ints(bitmap, packed, n_tiles: int, tile_elems: int,
                transform: str) -> torch.Tensor:
    """Section rows -> (n_tiles, tile_elems) signed ints in the words'
    width: the inverse of the integer encode's ``transform``."""
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform {transform!r} (want {TRANSFORMS})")
    chunks = bitunshuffle(rze_decode(bitmap, packed))
    if transform != "raw":
        chunks = zigzag_decode(chunks)
    if transform == "delta":
        chunks = delta_decode(chunks)
    rows, chunk_len = chunks.shape
    cpt = rows // n_tiles
    return chunks.reshape(n_tiles, cpt * chunk_len)[:, :tile_elems]


def decode_tiles_plain(bitmap, packed, sub_bitmap, sub_packed, eps,
                       tile_elems: int, dtype: torch.dtype) -> torch.Tensor:
    """Op-for-op torch version of the Pallas kernel body."""
    batch = eps.shape[0]
    bins = expand_ints(bitmap, packed, batch, tile_elems, "delta")
    if sub_bitmap is None:
        subs = torch.zeros_like(bins)
    else:
        subs = expand_ints(sub_bitmap, sub_packed, batch, tile_elems, "raw")
    return dequantize_tiles(bins, subs, eps, dtype)


def decode_tiles_fused(bitmap, packed, sub_bitmap, sub_packed, eps,
                       tile_elems: int, dtype: torch.dtype) -> torch.Tensor:
    """Decode a tile batch -> (batch, tile_elems) ``dtype``: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors.  Pass
    ``sub_bitmap = sub_packed = None`` for a batch without a subbin
    stream (counted as ``decode_tiles_fused_nosub``)."""
    if not eps.is_cuda:
        return decode_tiles_plain(bitmap, packed, sub_bitmap, sub_packed, eps,
                                  tile_elems, dtype)
    plain = sub_bitmap is None
    if plain != (sub_packed is None):
        raise ValueError("pass both subbin arrays or neither")
    streams = ((bitmap, packed),) if plain else ((bitmap, packed),
                                                 (sub_bitmap, sub_packed))
    _lib.require_cuda(*(a for pair in streams for a in pair), eps)
    if dtype not in (torch.float32, torch.float64) or eps.dtype != torch.float64:
        raise ValueError("decode_tiles_fused decodes f32/f64 with f64 eps")
    batch = eps.shape[0]
    cpts = []
    for bm, pk in streams:
        if bm.dtype != pk.dtype or bm.dtype not in (torch.int16, torch.int32,
                                                    torch.int64):
            raise ValueError("stream words must be int16/32/64 in both arrays")
        if bm.data_ptr() % 16 or pk.data_ptr() % 16:
            raise ValueError("stream arrays must start on a 16-byte boundary")
        w = width(pk.dtype)
        chunk_len = 131072 // w
        rows = pk.shape[0]
        if (pk.dim() != 2 or bm.dim() != 2 or pk.shape[1] != chunk_len
                or tuple(bm.shape) != (rows, chunk_len // w) or batch == 0
                or rows % batch):
            raise ValueError("stream rows must be (batch*cpt, 16 KiB chunk)")
        cpt = rows // batch
        if cpt * chunk_len < tile_elems:
            raise ValueError("streams hold fewer chunks than a tile needs")
        cpts.append(cpt)
    out = torch.empty((batch, tile_elems), dtype=dtype, device=eps.device)
    bits = torch.finfo(dtype).bits
    if plain:
        _lib.call("fused_decode", "lopc_decode_tiles_plain", bitmap, packed,
                  eps, out, batch, tile_elems, width(packed.dtype), cpts[0],
                  bits)
        _lib.LAUNCHES["decode_tiles_fused_nosub"] += 1
        return out
    _lib.call("fused_decode", "lopc_decode_tiles", bitmap, packed, sub_bitmap,
              sub_packed, eps, out, batch, tile_elems, width(packed.dtype),
              width(sub_packed.dtype), cpts[0], cpts[1], bits)
    _lib.LAUNCHES["decode_tiles_fused"] += 1
    return out


def dequantize_ff32(bins: torch.Tensor, subbins: torch.Tensor,
                    eps32) -> torch.Tensor:
    """int32 bins and subbins of one shape -> f32 values of that shape:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if not bins.is_cuda:
        return dequantize_ff32_ref(bins, subbins, eps32)
    if bins.dtype != torch.int32 or subbins.dtype != torch.int32:
        raise ValueError("dequantize_ff32 takes int32 bins and subbins")
    if bins.shape != subbins.shape:
        raise ValueError("bins and subbins must have one shape")
    bins, subbins = bins.contiguous(), subbins.contiguous()
    _lib.require_cuda(bins, subbins)
    out = torch.empty(bins.shape, dtype=torch.float32, device=bins.device)
    _lib.call("ff32", "lopc_dequantize_ff32", bins, subbins, out, bins.numel(),
              float(np.float32(eps32)))
    _lib.LAUNCHES["dequantize_ff32"] += 1
    return out
