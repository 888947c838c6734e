"""FF32 quantize (port of ``repro.kernels.quantize_kernel.quantize_ff32``).

One elementwise pass: ``b = rne(x * (1/eps32))`` with a saturating
int32 conversion, then two verify-and-correct passes against
``(f32(b) -+ 0.5) * eps32``, all in f32/int32 (the FF32 contract in
``ref.py``).  The kernel takes the field flat, with no padding to the
reference's (256, 128) TPU rows.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _lib
from .ref import quantize_ff32_ref


def quantize_ff32(x: torch.Tensor, eps32) -> torch.Tensor:
    """f32 ``x`` of any shape -> int32 bins of that shape: the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return quantize_ff32_ref(x, eps32)
    if x.dtype != torch.float32:
        raise ValueError("quantize_ff32 takes float32 values")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    # a double holding the f32 value exactly: the C side's cast is exact
    _lib.call("ff32", "lopc_quantize_ff32", x, out, x.numel(),
              float(np.float32(eps32)))
    _lib.LAUNCHES["quantize_ff32"] += 1
    return out
