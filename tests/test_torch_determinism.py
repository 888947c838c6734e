"""JAX-free oracles for the port: the SHA-256 of every non-chain,
non-adaptive container of ``benchmarks/baselines/determinism_hashes.json``
(4 generators x 3 shapes x f32/f64, eb 1e-2 NOA), built with the port's
own copy of the generators; and the committed v2 fixtures decoding to
``tests/data/expected.npz``.  Nothing here imports ``jax`` or ``repro``.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch import engine
from repro_torch.data.fields import FIELD_GENERATORS, make_scientific_field

REPO = Path(__file__).resolve().parents[1]
MANIFEST = json.loads(
    (REPO / "benchmarks" / "baselines" / "determinism_hashes.json").read_text())
DATA = REPO / "tests" / "data"
EB = 1e-2
SHAPES = ((13, 11, 9), (40, 28), (500,))
SNAPSHOT_CASES = [
    (name, shape, dtype)
    for name in sorted(FIELD_GENERATORS) for shape in SHAPES
    for dtype in ("float32", "float64")
]


def test_snapshot_cases_are_the_manifests():
    keys = {f"{n}/{'x'.join(map(str, s))}/{d}" for n, s, d in SNAPSHOT_CASES}
    snap = {k for k in MANIFEST if not k.startswith(("chain", "adaptive"))}
    assert keys == snap and len(keys) == 24


@pytest.mark.parametrize("name", sorted(FIELD_GENERATORS))
def test_manifest_hashes_and_round_trip(name):
    for shape in SHAPES:
        for dtype in ("float32", "float64"):
            case = f"{name}/{'x'.join(map(str, shape))}/{dtype}"
            x = make_scientific_field(name, shape, np.dtype(dtype), seed=5)
            blob = engine.compress(x, EB, device="cpu")
            assert hashlib.sha256(blob).hexdigest() == MANIFEST[case], case
            y = engine.decompress(blob, device="cpu")
            bound = EB * (float(x.max()) - float(x.min()))
            assert np.abs(x.astype(np.float64) - y.astype(np.float64)).max() <= bound


@pytest.mark.parametrize("name,fname", [("v2", "fixture_v2.lopc"),
                                        ("v2_wide", "fixture_v2_wide.lopc"),
                                        ("v2_adaptive", "fixture_v2_adaptive.lopc")])
def test_v2_fixtures_decode_to_expected(name, fname):
    want = np.load(DATA / "expected.npz")[name]
    got = engine.decompress((DATA / fname).read_bytes(), device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
