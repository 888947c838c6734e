"""Synthetic scientific fields made on the device from a seed.

The formulas are the repository's ``turbulence`` (power-law spectral
noise, amplitude k^-11/6, an S3D/ISABEL stand-in) and ``gaussians`` (24
Gaussian blobs of random centre, width 0.02-0.25 and amplitude in
[-1, 1], a Miranda stand-in; here widths and amplitudes are drawn
stratified), rewritten in torch so a full-size field takes milliseconds
on the card instead of seconds on the host.  They
are frozen here: the program's own generators may change without
moving the benchmark's inputs.

Each field is a function of (generator, shape, dtype, seed) alone on
one kind of device.  Random numbers come from a ``torch.Generator`` on
that device, drawn in a few large calls, in float64; the result is
cast to the field's dtype once.
"""
from __future__ import annotations

import hashlib

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def field_seed(seed: int, config: str, index: int) -> int:
    """The generator seed of pool field ``index`` of ``config`` under the
    run's ``seed`` (any integer): 63 bits of a hash, so distinct runs and
    distinct pool slots draw unrelated streams."""
    h = hashlib.sha256(f"{config}/{int(seed)}/{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _freqs(n: int, device) -> torch.Tensor:
    return torch.fft.fftfreq(n, device=device, dtype=torch.float64) * n


def turbulence(shape, g: torch.Generator) -> torch.Tensor:
    dev = g.device
    re = torch.randn(shape, generator=g, device=dev, dtype=torch.float64)
    im = torch.randn(shape, generator=g, device=dev, dtype=torch.float64)
    spec = torch.complex(re, im)
    del re, im
    k2 = torch.zeros(shape, device=dev, dtype=torch.float64)
    for axis, n in enumerate(shape):
        view = [1] * len(shape)
        view[axis] = n
        k2 += (_freqs(n, dev) ** 2).view(view)
    k2[(0,) * len(shape)] = 1.0
    spec *= k2.pow_(-11.0 / 12.0)  # energy ~ k^-5/3
    del k2
    x = torch.fft.ifftn(spec).real
    return x / x.abs().max()


def gaussians(shape, g: torch.Generator) -> torch.Tensor:
    dev = g.device
    nd = len(shape)
    p = torch.rand((24, nd + 2), generator=g, device=dev, dtype=torch.float64)
    axes = [torch.linspace(0, 1, n, device=dev, dtype=torch.float64)
            for n in shape]
    x = torch.zeros(shape, device=dev, dtype=torch.float64)
    # widths and amplitudes are drawn stratified (one draw in each 24th
    # of their ranges, shuffled), so every seed gets the same spread of
    # blob sizes and the work of a field varies little from seed to seed
    strata = (torch.arange(24, device=dev, dtype=torch.float64)[:, None]
              + p[:, nd:]) / 24
    for col in range(2):
        strata[:, col] = strata[torch.randperm(24, generator=g, device=dev), col]
    for c, w, a in zip(p[:, :nd], 0.02 + 0.23 * strata[:, 0], 2 * strata[:, 1] - 1):
        blob = a
        for axis, (coord, ci) in enumerate(zip(axes, c)):
            view = [1] * nd
            view[axis] = coord.numel()
            blob = blob * torch.exp(-((coord - ci) ** 2) / (2 * w * w)).view(view)
        x += blob
    return x


GENERATORS = {"turbulence": turbulence, "gaussians": gaussians}


def make(generator: str, shape, dtype: str, seed: int, device) -> torch.Tensor:
    """One field on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return GENERATORS[generator](tuple(shape), g).to(DTYPES[dtype])
