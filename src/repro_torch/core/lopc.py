"""LOPC public API (port of ``repro.core.lopc``).

    blob   = compress(field, eb=1e-2, mode="noa")
    field2 = decompress(blob)

``compress`` writes v2 (tiled) containers through the port's engine by
default; ``container_version=1`` writes the legacy whole-field v1
container, and ``decompress`` reads both.  The v1 path quantizes the
whole field, solves the subbins on the whole field
(``core.subbin.solve_subbins``; ``solver="auto"`` runs the band-solve
kernel on CUDA, ``jacobi`` on the CPU) and encodes each stream through
``codecs.pipeline``.  Its bytes equal the reference's v1 container, and
its decode equals the v2 decode of the same field bit for bit.

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no
CUDA device it raises unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codecs import pipeline
from . import bitstream
from .nonfinite import decode_nonfinite, encode_nonfinite
from .quantize import abs_bound_from_mode, bin_dtype_for, check_bin_range, dequantize, quantize
from .subbin import solve_subbins

TAG_BINS = bitstream.TAG_BINS
TAG_SUBBINS = bitstream.TAG_SUBBINS
TAG_NONFINITE = bitstream.TAG_NONFINITE

FLAG_ORDER_PRESERVING = bitstream.FLAG_ORDER_PRESERVING
FLAG_HAS_NONFINITE = bitstream.FLAG_HAS_NONFINITE

__all__ = ["CompressStats", "compress", "decompress", "compression_ratio"]

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


@dataclass
class CompressStats:
    raw_bytes: int
    total_bytes: int
    bin_bytes: int
    subbin_bytes: int
    header_bytes: int
    n_sweeps: int
    eps_abs: float

    @property
    def ratio(self) -> float:
        return self.raw_bytes / self.total_bytes


# the engine is imported lazily inside the functions: core.lopc is a leaf
# module the engine itself depends on (CompressStats)

def compress(field, eb: float, mode: str = "noa", preserve_order: bool = True,
             solver: str = "auto", return_stats: bool = False,
             container_version: int = bitstream.VERSION_TILED, plan=None,
             device="cuda"):
    """Compress a 1/2/3-D scalar field. Returns bytes (and stats)."""
    if container_version == bitstream.VERSION_TILED:
        from .. import engine as _engine

        return _engine.compress(field, eb, mode, preserve_order, solver,
                                plan=plan, return_stats=return_stats,
                                device=device)
    if container_version != bitstream.VERSION:
        raise ValueError(f"unknown container version {container_version}")
    return _compress_v1(field, eb, mode, preserve_order, solver, return_stats,
                        device)


def _compress_v1(field, eb, mode, preserve_order, solver, return_stats,
                 device):
    """Legacy whole-field v1 writer (byte compatibility, and the
    whole-field oracle the tiled engine is held to)."""
    x = np.asarray(field)
    if x.dtype not in (np.float32, np.float64):
        raise ValueError(f"LOPC compresses float32/float64 fields, got {x.dtype}")
    if x.ndim not in (1, 2, 3):
        raise ValueError(f"LOPC supports 1D/2D/3D grids, got ndim={x.ndim}")
    if eb <= 0:
        raise ValueError("error bound must be positive")
    from ..engine import resolve_device

    dev = resolve_device(device)
    nonfinite_payload = None
    if not np.isfinite(x).all():
        x, nonfinite_payload = encode_nonfinite(x)

    eps_abs = abs_bound_from_mode(x, eb, mode)
    if eps_abs < float(np.finfo(x.dtype).tiny):
        raise ValueError(
            f"error bound {eps_abs:.3e} is below the smallest normal "
            f"{x.dtype} ({np.finfo(x.dtype).tiny:.3e}); sub-denormal bin "
            "widths cannot be honored")
    check_bin_range(x, eps_abs)

    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    bins = quantize(xt, eps_abs)
    n_sweeps = 0
    flags = 0
    sections = {}
    if preserve_order:
        subbins, n_sweeps = solve_subbins(bins, xt, method=solver)
        flags |= FLAG_ORDER_PRESERVING
        sections[TAG_SUBBINS] = pipeline.encode_subbins(subbins)
    sections[TAG_BINS] = pipeline.encode_bins(bins)
    if nonfinite_payload is not None:
        flags |= FLAG_HAS_NONFINITE
        sections[TAG_NONFINITE] = nonfinite_payload

    header = bitstream.Header(dtype=x.dtype, shape=x.shape, eb_mode=mode,
                              eb=float(eb), eps_abs=float(eps_abs),
                              flags=flags)
    blob = bitstream.write_container(header, sections)
    if not return_stats:
        return blob
    stats = CompressStats(
        raw_bytes=x.nbytes,
        total_bytes=len(blob),
        bin_bytes=len(sections[TAG_BINS]),
        subbin_bytes=len(sections.get(TAG_SUBBINS, b"")),
        header_bytes=len(blob) - sum(len(s) for s in sections.values()),
        n_sweeps=int(n_sweeps),
        eps_abs=eps_abs,
    )
    return blob, stats


def decompress(blob: bytes, device="cuda") -> np.ndarray:
    """Reconstruct the field, dispatching on the container version byte:
    v2 (tiled) through the engine, v3 (a temporal chain) through
    ``temporal.decompress_chain`` as a ``(n_frames, *shape)`` stack, v1
    through the whole-field path."""
    version = bitstream.container_version(blob)
    if version == bitstream.VERSION_TILED:
        from .. import engine as _engine

        return _engine.decompress(blob, device=device)
    if version == bitstream.VERSION_CHAIN:
        from .. import temporal as _temporal

        return _temporal.decompress_chain(blob, device=device)
    return _decompress_v1(blob, device)


def _decompress_v1(blob: bytes, device) -> np.ndarray:
    from ..engine import resolve_device

    header, sections = bitstream.read_container(blob)
    dev = resolve_device(device)
    n = int(np.prod(header.shape))
    bdt = bin_dtype_for(_TORCH_DTYPE[np.dtype(header.dtype)])
    bins = pipeline.decode_bins(sections[TAG_BINS], n, header.shape, bdt, dev)
    if header.flags & FLAG_ORDER_PRESERVING:
        subbins = pipeline.decode_subbins(sections[TAG_SUBBINS], n,
                                          header.shape, bdt, dev)
    else:
        subbins = torch.zeros(header.shape, dtype=bdt, device=dev)
    out = dequantize(bins, subbins, header.eps_abs,
                     _TORCH_DTYPE[np.dtype(header.dtype)]).cpu().numpy()
    if header.flags & FLAG_HAS_NONFINITE:
        out = decode_nonfinite(sections[TAG_NONFINITE], out)
    return out


def compression_ratio(field, eb: float, mode: str = "noa", **kw) -> float:
    _, stats = compress(field, eb, mode, return_stats=True, **kw)
    return stats.ratio
