"""Whole-field compressor pipelines (port of ``repro.codecs.pipeline``).

Bins    (PFPL lossless portion): chunk -> delta -> zigzag -> BIT_w -> RZE_w
Subbins (LC-generated):          chunk ->                   BIT_w -> RZE_w
Both end with the host RZE_1 byte stage (``core.bitstream``, applied when
it shrinks the stream).

f32 fields: 4096-word chunks of 32-bit words (16 KiB, BIT_4 RZE_4 RZE_1).
The device stages are the hand-written kernels of the reference's TPU
forms for exactly these operands: the BIT_4 transpose and its inverse
(``kernels.ops.bitshuffle_u32`` / ``bitunshuffle_u32``) and the RZE
bitmap with its counts (``kernels.ops.rze_bitmap_u32``); the compaction
of the nonzero words is torch ops (``codecs.rze.rze_compact``), as the
TPU kernel leaves it to XLA.

f64 fields: 2048-word chunks of 64-bit words (16 KiB, BIT_8 RZE_8 RZE_1)
through the port's torch codecs.  This is the reference's own route for
this width, not a fallback: its TPU kernels are 32-bit only, and it has
no Pallas form for 64-bit words either.

Words ride in the signed twin of their width (``codecs`` docstring).
Arrays stay on the device of the input; only the encoded streams cross
to the host, and only the section payload crosses back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import bitstream
from ..kernels import ops
from .bitshuffle import bitshuffle, bitunshuffle
from .rze import rze_compact, rze_decode, rze_encode
from .transforms import (
    NP_UNSIGNED,
    chunk,
    delta_decode,
    delta_encode,
    unchunk,
    width,
    zigzag_decode,
    zigzag_encode,
)

CHUNK_WORDS = {4: 4096, 8: 2048}  # word bytes -> words per 16 KiB chunk


def chunk_len_for(dtype) -> int:
    """Words per 16 KiB chunk of a torch or numpy integer dtype."""
    return CHUNK_WORDS[dtype.itemsize if isinstance(dtype, torch.dtype)
                       else np.dtype(dtype).itemsize]


def _encode_device(ints: torch.Tensor, chunk_len: int, use_delta: bool):
    chunks, _ = chunk(ints, chunk_len)
    words = zigzag_encode(delta_encode(chunks)) if use_delta else chunks
    if width(words.dtype) == 32:
        shuffled = ops.bitshuffle_u32(words)
        bitmap, counts = ops.rze_bitmap_u32(shuffled)
        return bitmap, rze_compact(shuffled), counts
    return rze_encode(bitshuffle(words))


def _decode_device(bitmap: torch.Tensor, packed: torch.Tensor, n_valid: int,
                   shape, use_delta: bool) -> torch.Tensor:
    shuffled = rze_decode(bitmap, packed)
    if width(shuffled.dtype) == 32:
        words = ops.bitunshuffle_u32(shuffled)
    else:
        words = bitunshuffle(shuffled)
    chunks = delta_decode(zigzag_decode(words)) if use_delta else words
    return unchunk(chunks, n_valid, shape)


def _host(a: torch.Tensor) -> np.ndarray:
    """A device array of signed-twin words as host unsigned words."""
    a = a.cpu().numpy()
    return a.view(NP_UNSIGNED[a.dtype.itemsize])


def encode_ints(ints: torch.Tensor, use_delta: bool) -> bytes:
    """Full pipeline: device transforms + host serialization."""
    if ints.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"the v1 pipeline encodes int32/int64, got {ints.dtype}")
    bitmap, packed, counts = _encode_device(ints, chunk_len_for(ints.dtype),
                                            use_delta)
    return bitstream.serialize_rze_section(_host(bitmap), _host(packed),
                                           counts.cpu().numpy())


def decode_ints(payload: bytes, n_valid: int, shape, out_dtype: torch.dtype,
                use_delta: bool, device="cuda") -> torch.Tensor:
    """-> (shape) ``out_dtype`` tensor on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""
    from ..engine.engine import resolve_device

    dev = resolve_device(device)
    bitmap, packed = bitstream.deserialize_rze_section(payload)
    sdt = np.dtype(f"<i{bitmap.dtype.itemsize}")
    out = _decode_device(torch.from_numpy(bitmap.view(sdt)).to(dev),
                         torch.from_numpy(packed.view(sdt)).to(dev),
                         n_valid, tuple(shape), use_delta)
    return out.to(out_dtype)


def encode_bins(bins: torch.Tensor) -> bytes:
    """PFPL lossless portion (delta + zigzag + BIT + RZE [+ RZE_1])."""
    return encode_ints(bins, use_delta=True)


def decode_bins(payload: bytes, n_valid: int, shape, bin_dtype,
                device="cuda") -> torch.Tensor:
    return decode_ints(payload, n_valid, shape, bin_dtype, True, device)


def encode_subbins(subbins: torch.Tensor) -> bytes:
    """LC pipeline BIT_w RZE_w [RZE_1]; no delta (subbins are near zero
    already; a delta would make sign noise)."""
    return encode_ints(subbins, use_delta=False)


def decode_subbins(payload: bytes, n_valid: int, shape, sub_dtype,
                   device="cuda") -> torch.Tensor:
    return decode_ints(payload, n_valid, shape, sub_dtype, False, device)
