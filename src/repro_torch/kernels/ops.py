"""Public wrappers around the whole-field kernels (port of
``repro.kernels.ops``).

Every wrapper runs on its tensors' device: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.  They take inputs of any
size: the CUDA kernels need no padding to the reference's TPU blocks
(``BLOCK_CHUNKS``, the (256, 128) rows of the FF32 pair), and the FF32
functions take any shape and give back that shape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import topology
from . import bitshuffle_kernel, fused_decode, quantize_kernel, rze_kernel, subbin_sweep
from .ref import FF32_MAX_BIN, canonical3d


def quantize_ff32(x: torch.Tensor, eps32) -> torch.Tensor:
    """FF32-contract quantization of an array of any shape (cast to f32)
    -> int32 bins of that shape."""
    return quantize_kernel.quantize_ff32(x.to(torch.float32), eps32)


def dequantize_ff32(bins: torch.Tensor, subbins: torch.Tensor,
                    eps32) -> torch.Tensor:
    """FF32 decode of int32 bins plus subbins (any shape) -> f32."""
    return fused_decode.dequantize_ff32(bins.to(torch.int32),
                                        subbins.to(torch.int32), eps32)


def ff32_domain_ok(x, eps32, device="cuda") -> bool:
    """|bin| < 2^23 validity check for the FF32 contract (a NaN fails it).
    ``x`` is a tensor (reduced on its own device) or anything numpy reads
    (uploaded to ``device`` and reduced there)."""
    if not isinstance(x, torch.Tensor):
        from ..engine import resolve_device

        x = torch.from_numpy(np.asarray(x, np.float64)).to(
            resolve_device(device))
    top = float(x.to(torch.float64).abs().max())
    return top / float(eps32) < FF32_MAX_BIN - 2


def bitshuffle_u32(words: torch.Tensor) -> torch.Tensor:
    """(C, 4096) int32 words, any C."""
    return bitshuffle_kernel.bitshuffle_u32(words)


def bitunshuffle_u32(words: torch.Tensor) -> torch.Tensor:
    return bitshuffle_kernel.bitunshuffle_u32(words)


def rze_bitmap_u32(words: torch.Tensor):
    """-> (bitmap (C, 128) int32, counts (C,) int32)."""
    return rze_kernel.rze_bitmap_u32(words)


def solve_subbins_blockwise(bins: torch.Tensor, values: torch.Tensor):
    """Whole-field band solve (the paper's worklist, band form).

    Same least fixed point as ``core.subbin``'s jacobi/frontier.  Subbins
    are computed in int32 (fields < 2^31 points cannot exceed the int32
    subbin range) and cast to the bin width.  Returns (subbins, global
    sweeps).
    """
    flags = topology.order_flags(canonical3d(bins), canonical3d(values))
    sub, sweeps = subbin_sweep.solve_blockwise(flags)
    out_dtype = torch.int32 if bins.dtype == torch.int32 else torch.int64
    return sub.reshape(bins.shape).to(out_dtype), sweeps
