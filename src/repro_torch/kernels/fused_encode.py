"""Fused encodes (port of ``repro.kernels.fused_encode``).

``encode_ints_fused``: (batch, E) signed ints -> per 16 KiB chunk:
[delta -> zigzag | zigzag | reinterpret] -> BIT_W -> RZE bitmap, as (bitmap
(batch*cpt, L/W), shuffled words (batch*cpt, L), counts (batch*cpt,)
int32).  Words travel in the signed twin of their width.

``encode_values_fused``: the plain (preserve_order=False) f32 compress
in one kernel: (batch, E) NaN-marked f32 interiors and (batch,) f64 eps
-> non-finite cells to 0 -> ``quantize_broadcast`` -> the bins store
width -> the ``delta`` chain above.
"""
from __future__ import annotations

import torch

from ..codecs.bitshuffle import bitshuffle
from ..codecs.rze import rze_bitmap
from ..codecs.transforms import delta_encode, width, zigzag_encode
from ..core.quantize import quantize_broadcast
from . import _lib

# index = the kernel's transform code
TRANSFORMS = ("raw", "delta", "zigzag")


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
    elif transform == "zigzag":
        words = zigzag_encode(chunks)
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
    _lib.TRANSFORM_LAUNCHES[f"encode_ints_fused_{transform}"] += 1
    return bitmap, words, counts


def encode_values_plain(x_int: torch.Tensor, eps: torch.Tensor, chunk_len: int,
                        dtype: torch.dtype, bins_store: torch.dtype):
    """Op-for-op torch version of the Pallas kernel body of
    ``encode_values_fused``."""
    valid = torch.isfinite(x_int)
    x0 = torch.where(valid, x_int, torch.zeros((), dtype=x_int.dtype,
                                                device=x_int.device))
    bins = quantize_broadcast(x0, eps[:, None], dtype)
    bins = torch.where(valid, bins, 0).to(bins_store)
    return encode_ints_plain(bins, chunk_len, "delta")


def encode_values_fused(x_int: torch.Tensor, eps: torch.Tensor, chunk_len: int,
                        dtype: torch.dtype, bins_store: torch.dtype):
    """Quantize and encode a (batch, E) f32 batch into the bins stream:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors.
    f32 only, as in the reference (f64 runs the quantize stage and
    ``encode_ints_fused``)."""
    if not x_int.is_cuda:
        return encode_values_plain(x_int, eps, chunk_len, dtype, bins_store)
    _lib.require_cuda(x_int, eps)
    if (dtype != torch.float32 or x_int.dtype != torch.float32
            or eps.dtype != torch.float64):
        raise ValueError("encode_values_fused takes f32 values with f64 eps")
    if bins_store not in (torch.int16, torch.int32):
        raise ValueError(f"encode_values_fused stores int16/int32 bins, "
                         f"got {bins_store}")
    w = width(bins_store)
    b, e = x_int.shape if x_int.dim() == 2 else (-1, -1)
    if b < 0 or tuple(eps.shape) != (b,) or chunk_len != 131072 // w:
        raise ValueError(f"encode_values_fused takes (batch, E) values, "
                         f"(batch,) eps and 16 KiB chunks ({131072 // w} "
                         f"words of {w} bits)")
    rows = b * -(-e // chunk_len)
    dev = x_int.device
    bitmap = torch.empty((rows, chunk_len // w), dtype=bins_store, device=dev)
    words = torch.empty((rows, chunk_len), dtype=bins_store, device=dev)
    counts = torch.empty((rows,), dtype=torch.int32, device=dev)
    _lib.call("fused_encode", "lopc_encode_values", x_int, eps, bitmap, words,
              counts, b, e, w)
    _lib.LAUNCHES["encode_values_fused"] += 1
    return bitmap, words, counts
