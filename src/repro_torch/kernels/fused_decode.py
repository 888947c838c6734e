"""Fused ordered decode (port of
``repro.kernels.fused_decode.decode_tiles_fused``).

RZE expand -> BIT_W un-transpose -> dezigzag + wrapping prefix sum
(bins) or raw (subbins) -> ``decode_base`` with the per-tile eps -> the
ordered-int subbin add.  Covers f32 and f64 outputs and every stream
word width.
"""
from __future__ import annotations

import torch

from ..codecs.bitshuffle import bitunshuffle
from ..codecs.rze import rze_decode
from ..codecs.transforms import delta_decode, width, zigzag_decode
from ..core.floatbits import float_to_ordered, int_dtype_for, ordered_to_float
from ..core.quantize import decode_base
from . import _lib


def _expand_ints(bitmap, packed, n_tiles: int, tile_elems: int,
                 transform: str) -> torch.Tensor:
    """Section rows -> (n_tiles, tile_elems) signed ints."""
    words = bitunshuffle(rze_decode(bitmap, packed))
    chunks = delta_decode(zigzag_decode(words)) if transform == "delta" else words
    rows, chunk_len = chunks.shape
    cpt = rows // n_tiles
    return chunks.reshape(n_tiles, cpt * chunk_len)[:, :tile_elems]


def decode_tiles_plain(bitmap, packed, sub_bitmap, sub_packed, eps,
                       tile_elems: int, dtype: torch.dtype) -> torch.Tensor:
    """Op-for-op torch version of the Pallas kernel body."""
    batch = eps.shape[0]
    bins = _expand_ints(bitmap, packed, batch, tile_elems, "delta")
    subs = _expand_ints(sub_bitmap, sub_packed, batch, tile_elems, "raw")
    base = decode_base(bins, eps[:, None], dtype)
    idt = int_dtype_for(dtype)
    # a subbin stream wider than the ordered ints accumulates in its own
    # width; the final ordered value always fits idt
    if subs.element_size() > base.element_size():
        o = float_to_ordered(base).to(subs.dtype) + subs
        return ordered_to_float(o.to(idt), dtype)
    return ordered_to_float(float_to_ordered(base) + subs.to(idt), dtype)


def decode_tiles_fused(bitmap, packed, sub_bitmap, sub_packed, eps,
                       tile_elems: int, dtype: torch.dtype) -> torch.Tensor:
    """Decode a tile batch -> (batch, tile_elems) ``dtype``: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if not eps.is_cuda:
        return decode_tiles_plain(bitmap, packed, sub_bitmap, sub_packed, eps,
                                  tile_elems, dtype)
    _lib.require_cuda(bitmap, packed, sub_bitmap, sub_packed, eps)
    if dtype not in (torch.float32, torch.float64) or eps.dtype != torch.float64:
        raise ValueError("decode_tiles_fused decodes f32/f64 with f64 eps")
    batch = eps.shape[0]
    cpts = []
    for bm, pk in ((bitmap, packed), (sub_bitmap, sub_packed)):
        if bm.dtype != pk.dtype or bm.dtype not in (torch.int16, torch.int32,
                                                    torch.int64):
            raise ValueError("stream words must be int16/32/64 in both arrays")
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
    _lib.call("fused_decode", "lopc_decode_tiles", bitmap, packed, sub_bitmap,
              sub_packed, eps, out, batch, tile_elems, width(packed.dtype),
              width(sub_packed.dtype), cpts[0], cpts[1],
              torch.finfo(dtype).bits)
    _lib.LAUNCHES["decode_tiles_fused"] += 1
    return out
