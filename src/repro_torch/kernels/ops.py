"""Public wrappers around the whole-field kernels (port of
``repro.kernels.ops``).

The wrappers take chunks of any count ``C``: the CUDA kernels need no
padding to the reference's ``BLOCK_CHUNKS``.  The FF32 quantize and
dequantize pair is not ported yet (ROADMAP.md kernel queue items 6-7).
"""
from __future__ import annotations

import torch

from ..core import topology
from . import bitshuffle_kernel, rze_kernel, subbin_sweep
from .ref import canonical3d


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} is not ported yet: ROADMAP.md kernel queue items 6-7 (the "
        "FF32 quantize and dequantize pair) bring it")


def quantize_ff32(x, eps32):
    _not_ported("quantize_ff32")


def dequantize_ff32(bins, subbins, eps32):
    _not_ported("dequantize_ff32")


def ff32_domain_ok(x, eps32):
    _not_ported("ff32_domain_ok")


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
