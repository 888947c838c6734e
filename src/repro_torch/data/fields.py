"""Synthetic scientific scalar fields (a numpy copy of ``repro.data.fields``).

The paper's inputs (Isabel, Miranda, S3D, ... Table II) are not
redistributable in this container, so the benchmark harness generates
fields with matched qualitative statistics (DESIGN.md §6):

  gaussians   - multi-scale Gaussian mixture (Miranda-like smooth blobs)
  turbulence  - power-law spectral noise, k^-5/3 (S3D / Isabel-like)
  waves       - interfering plane waves (QMCPACK-like oscillatory)
  front       - moving sharp sigmoid front + noise (Ionization-like)

All generators are deterministic in (name, shape, seed).
"""
from __future__ import annotations

import zlib

import numpy as np


def _gaussians(shape, rng):
    x = np.zeros(shape)
    coords = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
    for _ in range(24):
        c = rng.uniform(0, 1, len(shape))
        w = rng.uniform(0.02, 0.25)
        a = rng.uniform(-1, 1)
        r2 = sum((g - ci) ** 2 for g, ci in zip(coords, c))
        x += a * np.exp(-r2 / (2 * w * w))
    return x


def _turbulence(shape, rng):
    spec = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ks = np.meshgrid(*[np.fft.fftfreq(n) * n for n in shape], indexing="ij")
    k2 = sum(k * k for k in ks)
    k2[tuple(0 for _ in shape)] = 1.0
    spec *= k2 ** (-11.0 / 12.0)  # energy ~ k^-5/3 -> amplitude k^-11/6
    x = np.real(np.fft.ifftn(spec))
    return x / np.abs(x).max()


def _waves(shape, rng):
    coords = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                         indexing="ij")
    x = np.zeros(shape)
    for _ in range(8):
        kvec = rng.uniform(0.02, 0.3, len(shape))
        phase = rng.uniform(0, 2 * np.pi)
        x += rng.uniform(0.2, 1.0) * np.sin(
            sum(k * g for k, g in zip(kvec, coords)) + phase
        )
    return x


def _front(shape, rng):
    coords = np.meshgrid(*[np.linspace(0, 1, n) for n in shape], indexing="ij")
    n_vec = rng.standard_normal(len(shape))
    n_vec /= np.linalg.norm(n_vec)
    proj = sum(nv * g for nv, g in zip(n_vec, coords))
    x = np.tanh((proj - 0.5) * 30.0)
    return x + 0.02 * rng.standard_normal(shape)


FIELD_GENERATORS = {
    "gaussians": _gaussians,
    "turbulence": _turbulence,
    "waves": _waves,
    "front": _front,
}

# benchmark stand-ins for the paper's Table II inputs
PAPER_INPUTS = {
    "isabel": ("turbulence", (48, 96, 96), np.float32),
    "tangaroa": ("turbulence", (72, 48, 32), np.float32),
    "earthquake": ("front", (96, 48, 16), np.float64),
    "ionization": ("front", (80, 32, 32), np.float64),
    "miranda": ("gaussians", (96, 96, 64), np.float64),
    "s3d": ("turbulence", (96, 96, 96), np.float64),
    "scale": ("gaussians", (128, 128, 24), np.float64),
    "qmcpack": ("waves", (36, 36, 56), np.float64),
}


def _spectrum(x: np.ndarray):
    """FFT + wavenumber grids of a field (helper for the sequence ops)."""
    spec = np.fft.fftn(x)
    ks = np.meshgrid(*[np.fft.fftfreq(n) for n in x.shape], indexing="ij")
    return spec, ks


def _advect(x0: np.ndarray, t: int, velocity: float) -> np.ndarray:
    """Periodic advection by ``velocity * t`` cells along every axis.

    Implemented as a Fourier phase shift, so fractional (sub-cell)
    velocities produce the smooth frame-to-frame drift real transport
    codes emit — the regime temporal residuals are built for.  (A whole-
    pixel np.roll is the *worst* correlated case: its bin residual is
    exactly the spatial gradient, i.e. what spatial delta already
    captures.)
    """
    spec, ks = _spectrum(x0)
    phase = sum(k * (velocity * t) for k in ks)
    return np.real(np.fft.ifftn(spec * np.exp(-2j * np.pi * phase)))


def _diffuse(x0: np.ndarray, t: int, rate: float) -> np.ndarray:
    """Heat-equation evolution: spectral decay exp(-rate * k^2 * t)."""
    spec, ks = _spectrum(x0)
    k2 = sum((2 * np.pi * k) ** 2 for k in ks)
    return np.real(np.fft.ifftn(spec * np.exp(-rate * k2 * t)))


# Default evolution parameters: a CFL-respecting sub-cell transport
# velocity and a mild diffusion rate — the frame-to-frame step sizes
# production solvers actually emit at typical output cadence.
SEQUENCE_EVOLUTIONS = {
    "advect": lambda x0, t: _advect(x0, t, velocity=0.15),
    "diffuse": lambda x0, t: _diffuse(x0, t, rate=0.25),
}


def make_field_sequence(evolution: str, base: str, shape, n_frames: int,
                        dtype=None, seed: int = 0) -> list[np.ndarray]:
    """Deterministic time series: a generator field evolved per frame.

    ``evolution`` picks the frame-to-frame operator (``advect`` — smooth
    periodic transport at a sub-cell velocity; ``diffuse`` — heat-
    equation decay); ``base`` is any :data:`FIELD_GENERATORS` name.
    Frame 0 is exactly ``make_scientific_field(base, shape, seed=seed)``.
    """
    evolve = SEQUENCE_EVOLUTIONS[evolution]
    x0 = make_scientific_field(base, shape, np.float64, seed=seed)
    dtype = dtype or np.float64
    return [evolve(x0, t).astype(dtype) for t in range(n_frames)]


def make_scientific_field(name: str, shape=None, dtype=None, seed: int = 0) -> np.ndarray:
    if name in PAPER_INPUTS:
        gen, default_shape, default_dtype = PAPER_INPUTS[name]
        shape = shape or default_shape
        dtype = dtype or default_dtype
    else:
        gen = name
        assert shape is not None
        dtype = dtype or np.float64
    # Stable digest, NOT Python's salted hash(): "deterministic in
    # (name, shape, seed)" must hold across processes and machines.
    key = f"{name}|{tuple(shape)}|{seed}".encode()
    rng = np.random.default_rng(zlib.crc32(key))
    return FIELD_GENERATORS[gen](tuple(shape), rng).astype(dtype)
