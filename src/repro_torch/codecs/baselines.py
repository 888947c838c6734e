"""The paper's comparison compressors (port of ``repro.codecs.baselines``,
paper §III), on the port's ``codecs.pipeline``.

Lossy, non-topology-preserving:
  * ``pfpl_lite``   — PFPL [13]: guaranteed-bound 2*eps quantization
                      (decode to bin center) + the PFPL lossless pipeline
                      (delta, sign fold, bit shuffle, RZE).
  * ``sz_lorenzo``  — SZ-style [9,26]: integer Lorenzo prediction on the
                      quantized field + residual coding.  The Lorenzo
                      residual is the separable finite difference
                      (1-S_x)(1-S_y)(1-S_z) q, inverted by per-axis
                      cumulative sums, wrapping in the bins' dtype.

Lossless (preserve everything, lower ratios):
  * ``lossless_fp`` — FPCompress-speed-like [3]: ordered-int bit map +
                      delta + zigzag + BIT + RZE. Exact.
  * ``zstd_raw``    — general-purpose Zstandard on the raw bytes [6].

Topology-aware reference:
  * ``topoqz_lite`` — TopoQZ-flavored [34]: PFPL-lite plus lossless
                      storage of values at detected extrema only
                      (``tda.classify_critical_points``).  It preserves
                      *some* critical points but misses saddles.

Every blob equals the reference's byte for byte and every decode its
values bit for bit.  The bins are quantized in f64 and cast to the
field's integer width, which matches the reference while they are in
range, as they are at ordinary bounds.  The transforms run on ``device``
(``"cuda"`` unless the caller passes ``"cpu"``); on the card f32 fields
take kernels 8 and 9 on 32-bit words (``codecs.pipeline``), and
``lossless_fp_decode`` the inverse of kernel 8.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..core import bitstream
from ..core.floatbits import float_to_ordered, int_dtype_for, ordered_to_float
from ..core.quantize import abs_bound_from_mode
from ..engine import resolve_device
from . import pipeline

try:  # optional; used only by zstd_raw
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None

_TORCH_FLOAT = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


@dataclass
class BaselineResult:
    blob: bytes
    decoded: np.ndarray
    raw_bytes: int

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(1, len(self.blob))


def _meta(x: np.ndarray, eps: float) -> bytes:
    w = bitstream.Writer()
    w.pack("BB", bitstream.DTYPE_CODES[np.dtype(x.dtype)], x.ndim)
    w.pack("Q" * x.ndim, *x.shape)
    w.pack("d", eps)
    return w.getvalue()


def _upload(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def _bins(x: np.ndarray, eps: float, device) -> torch.Tensor:
    """round(x / 2 eps) in f64, cast to the field's integer width."""
    xt = _upload(x, device)
    bdt = int_dtype_for(xt.dtype)
    return torch.round(xt.to(torch.float64) / (2.0 * eps)).to(bdt)


def _centers(q: torch.Tensor, eps: float, dtype) -> np.ndarray:
    """The bin centers q * 2 eps, in the field's dtype, on the host."""
    dec = (q.to(torch.float64) * (2.0 * eps)).to(_TORCH_FLOAT[np.dtype(dtype)])
    return dec.cpu().numpy()


# ------------------------------------------------------------ PFPL-lite

def pfpl_lite(x: np.ndarray, eb: float, mode: str = "noa",
              device="cuda") -> BaselineResult:
    eps = abs_bound_from_mode(x, eb, mode) * (1 - 2.0**-20)
    q = _bins(x, eps, device)
    payload = _meta(x, eps) + pipeline.encode_bins(q)
    return BaselineResult(payload, _centers(q, eps, x.dtype), x.nbytes)


# ----------------------------------------------------------- SZ-Lorenzo

def _lorenzo_residual(q: torch.Tensor) -> torch.Tensor:
    """Separable finite difference along every axis (integer Lorenzo)."""
    for ax in range(q.ndim):
        shifted = torch.zeros_like(q)
        shifted.narrow(ax, 1, q.shape[ax] - 1).copy_(
            q.narrow(ax, 0, q.shape[ax] - 1))
        q = q - shifted
    return q


def _lorenzo_restore(r: torch.Tensor) -> torch.Tensor:
    # torch.cumsum widens int32 to int64 unless told the dtype: keep the
    # bins' width, so the sums wrap as the reference's do
    for ax in range(r.ndim):
        r = torch.cumsum(r, dim=ax, dtype=r.dtype)
    return r


def sz_lorenzo(x: np.ndarray, eb: float, mode: str = "noa",
               device="cuda") -> BaselineResult:
    eps = abs_bound_from_mode(x, eb, mode) * (1 - 2.0**-20)
    q = _bins(x, eps, device)
    r = _lorenzo_residual(q)
    payload = _meta(x, eps) + pipeline.encode_bins(r)
    return BaselineResult(payload, _centers(_lorenzo_restore(r), eps, x.dtype),
                          x.nbytes)


# ----------------------------------------------------------- lossless FP

def lossless_fp(x: np.ndarray, device="cuda") -> BaselineResult:
    ints = float_to_ordered(_upload(x, device))
    payload = _meta(x, 0.0) + pipeline.encode_bins(ints)
    return BaselineResult(payload, np.asarray(x).copy(), x.nbytes)


def lossless_fp_decode(payload: bytes, device="cuda") -> np.ndarray:
    r = bitstream.Reader(payload)
    dtc, ndim = r.unpack("BB")
    shape = r.unpack("Q" * ndim)
    shape = (shape,) if ndim == 1 else tuple(shape)
    _ = r.unpack("d")
    tdt = _TORCH_FLOAT[bitstream.CODES_DTYPE[dtc]]
    n = int(np.prod(shape))
    ints = pipeline.decode_bins(payload[r.off:], n, shape, int_dtype_for(tdt),
                                resolve_device(device))
    return ordered_to_float(ints, tdt).cpu().numpy()


# ------------------------------------------------------------------ zstd

def zstd_raw(x: np.ndarray, level: int = 3) -> BaselineResult:
    if _zstd is None:  # pragma: no cover
        blob = zlib.compress(np.ascontiguousarray(x).tobytes(), 6)
    else:
        blob = _zstd.ZstdCompressor(level=level).compress(
            np.ascontiguousarray(x).tobytes()
        )
    return BaselineResult(blob, np.asarray(x).copy(), x.nbytes)


# ------------------------------------------------------------ TopoQZ-lite

def topoqz_lite(x: np.ndarray, eb: float, mode: str = "noa",
                device="cuda") -> BaselineResult:
    """PFPL-lite + lossless extrema pinning (misses saddles by design)."""
    from ..tda.critpoints import CLASS_MAX, CLASS_MIN, classify_critical_points

    base = pfpl_lite(x, eb, mode, device)
    cls = classify_critical_points(_upload(x, device)).cpu().numpy()
    pin = (cls == CLASS_MIN) | (cls == CLASS_MAX)
    dec = base.decoded.copy()
    dec[pin] = x[pin]
    extra = int(pin.sum()) * (x.dtype.itemsize + 4)  # value + index cost
    return BaselineResult(base.blob + b"\0" * extra, dec, x.nbytes)
