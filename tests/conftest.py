"""Shared test fixtures.

NOTE: XLA_FLAGS device-count overrides are NOT set here (the dry-run
sets its own 512-device flag in its own process). Tests see 1 device.
"""
from __future__ import annotations

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:  # offline container: deterministic fallback
    from _hypothesis_fallback import install

    install()
    from hypothesis import HealthCheck, settings

settings.register_profile(
    "repro",
    max_examples=25,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)
settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is present")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


def make_field(rng, shape, dtype=np.float64, smooth=True):
    """Synthetic scalar field with plenty of critical points."""
    axes = [np.linspace(0, 4 * np.pi, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    x = np.ones(shape)
    for i, g in enumerate(grids):
        x = x * np.sin(g + 0.3 * i)
    x = x + 0.05 * rng.standard_normal(shape)
    return x.astype(dtype)


@pytest.fixture
def field3d(rng):
    return make_field(rng, (20, 17, 14))


@pytest.fixture
def field2d(rng):
    return make_field(rng, (40, 33))
