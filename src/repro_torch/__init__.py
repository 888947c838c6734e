"""repro_torch — the PyTorch/CUDA port of LOPC.

LOPC (Local-Order-Preserving Compressor) is an error-bounded lossy
compressor for scalar fields that fully preserves local order and hence
all critical points (Fallin et al., CS.DC 2026).  This package mirrors
the layout of the JAX package ``repro`` (its reference) and must emit
byte-identical containers and bit-identical decoded values.

It imports ``torch`` and ``numpy`` only — never ``jax`` and never
``repro``.  The entry points (``repro_torch.engine``) run on the CUDA
device unless the caller passes ``device="cpu"``; on a CUDA tensor every
kernel stage launches its hand-written Hopper kernel
(``repro_torch.kernels``), on a CPU tensor its plain PyTorch version.
"""
from __future__ import annotations

__version__ = "0.1.0"
