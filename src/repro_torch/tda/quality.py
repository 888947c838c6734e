"""Reconstruction quality metrics (a numpy copy of ``repro.tda.quality``;
paper Tables VIII/IX): PSNR and SSIM."""
from __future__ import annotations

import numpy as np


def psnr(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """Peak signal-to-noise ratio over the original's value range.

    Defined on the degenerate cases: a perfect reconstruction is ``+inf``
    regardless of range, and a *constant* original (zero range) with any
    reconstruction error is ``-inf``, never a nan or a numpy divide
    warning.
    """
    o = np.asarray(original, np.float64)
    r = np.asarray(reconstructed, np.float64)
    rng = o.max() - o.min()
    mse = np.mean((o - r) ** 2)
    if mse == 0:
        return float("inf")
    if rng == 0:
        return float("-inf")
    return float(20.0 * np.log10(rng) - 10.0 * np.log10(mse))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter, same-size through edge padding.  The window
    is clamped to each axis extent, so tiny fields filter with the
    support they have."""
    for ax in range(x.ndim):
        s = min(int(size), x.shape[ax])
        if s <= 1:
            continue
        pad = [(0, 0)] * x.ndim
        pad[ax] = (s // 2, s - 1 - s // 2)
        xp = np.pad(x, pad, mode="edge")
        c = np.cumsum(xp, axis=ax, dtype=np.float64)
        lead = [slice(None)] * x.ndim
        lag = [slice(None)] * x.ndim
        lead[ax] = slice(s, None)
        lag[ax] = slice(None, -s)
        zero = [slice(None)] * x.ndim
        zero[ax] = slice(s - 1, s)
        first = c[tuple(zero)]
        x = np.concatenate([first, c[tuple(lead)] - c[tuple(lag)]], axis=ax) / s
    return x


def ssim(original: np.ndarray, reconstructed: np.ndarray, window: int = 7) -> float:
    """Mean SSIM with a box window (scikit-image style constants).

    A constant original (zero range) has no structure to compare: the
    score is 1.0 iff the reconstruction matches it exactly, else 0.0.
    """
    if window < 1:
        raise ValueError("ssim window must be >= 1")
    o = np.asarray(original, np.float64)
    r = np.asarray(reconstructed, np.float64)
    rng = o.max() - o.min()
    if rng == 0:
        return 1.0 if np.array_equal(o, r) else 0.0
    c1 = (0.01 * rng) ** 2
    c2 = (0.03 * rng) ** 2
    mu_o = _uniform_filter(o, window)
    mu_r = _uniform_filter(r, window)
    var_o = _uniform_filter(o * o, window) - mu_o**2
    var_r = _uniform_filter(r * r, window) - mu_r**2
    cov = _uniform_filter(o * r, window) - mu_o * mu_r
    num = (2 * mu_o * mu_r + c1) * (2 * cov + c2)
    den = (mu_o**2 + mu_r**2 + c1) * (var_o + var_r + c2)
    return float(np.mean(num / den))
