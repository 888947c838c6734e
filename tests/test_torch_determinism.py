"""JAX-free oracles for the port: the SHA-256 of every container of
``benchmarks/baselines/determinism_hashes.json`` (4 generators x 3
shapes x f32/f64, eb 1e-2 NOA; the 8 ``adaptive/*`` cases: 4 generators
x f32/f64 at (17, 14, 12) with ``adaptive_eb="tda"``; the 8 ``chain/*``
cases: 2 evolutions x 2 bases x f32/f64, 5 frames of (13, 11, 9) at
keyframe interval 2; the 4 ``chain-adaptive/*`` cases: 2 evolutions x
f32/f64, 5 frames of (17, 14, 12), adaptive), built with the port's own
copy of the generators; and the committed v2 fixtures decoding to
``tests/data/expected.npz``.  Nothing here imports ``jax`` or ``repro``.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import engine, temporal
from repro_torch.data.fields import (
    FIELD_GENERATORS,
    SEQUENCE_EVOLUTIONS,
    make_field_sequence,
    make_scientific_field,
)

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
ADAPTIVE_SHAPE = (17, 14, 12)
# the ladder's loosest rung: eb * 2**EB_LADDER_K_MAX
ADAPTIVE_LOOSE = 2.0**3
CHAIN_SHAPE, CHAIN_FRAMES, CHAIN_INTERVAL = (13, 11, 9), 5, 2
CHAIN_CASES = [f"chain/{evo}/{base}/{dtype}"
               for evo in sorted(SEQUENCE_EVOLUTIONS)
               for base in ("gaussians", "turbulence")
               for dtype in ("float32", "float64")] + [
    f"chain-adaptive/{evo}/{dtype}" for evo in sorted(SEQUENCE_EVOLUTIONS)
    for dtype in ("float32", "float64")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and a
    pool of threads in each of several test worker processes
    oversubscribes the cores, where a chain compress ran 50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_snapshot_cases_are_the_manifests():
    keys = {f"{n}/{'x'.join(map(str, s))}/{d}" for n, s, d in SNAPSHOT_CASES}
    keys |= {f"adaptive/{n}/{d}" for n in FIELD_GENERATORS
             for d in ("float32", "float64")}
    snap = {k for k in MANIFEST if not k.startswith("chain")}
    assert keys == snap and len(keys) == 32
    assert set(CHAIN_CASES) == set(MANIFEST) - snap and len(CHAIN_CASES) == 12


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


@pytest.mark.parametrize("name", sorted(FIELD_GENERATORS))
def test_adaptive_manifest_hashes_and_round_trip(name):
    for dtype in ("float32", "float64"):
        case = f"adaptive/{name}/{dtype}"
        x = make_scientific_field(name, ADAPTIVE_SHAPE, np.dtype(dtype), seed=5)
        blob = engine.compress(x, EB, adaptive_eb="tda", device="cpu")
        assert hashlib.sha256(blob).hexdigest() == MANIFEST[case], case
        y = engine.decompress(blob, device="cpu")
        bound = EB * ADAPTIVE_LOOSE * (float(x.max()) - float(x.min()))
        assert np.abs(x.astype(np.float64) - y.astype(np.float64)).max() <= bound


def _chain_frames(case: str):
    """The frames of a chain manifest case and its adaptive_eb value."""
    parts = case.split("/")
    if parts[0] == "chain":
        _, evo, base, dtype = parts
        return make_field_sequence(evo, base, CHAIN_SHAPE, CHAIN_FRAMES,
                                   np.dtype(dtype), seed=5), "off"
    _, evo, dtype = parts
    return make_field_sequence(evo, "gaussians", ADAPTIVE_SHAPE, CHAIN_FRAMES,
                               np.dtype(dtype), seed=5), "tda"


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_manifest_hashes_and_round_trip(case):
    frames, adaptive = _chain_frames(case)
    blob = temporal.compress_chain(frames, EB, keyframe_interval=CHAIN_INTERVAL,
                                   adaptive_eb=adaptive, device="cpu")
    assert hashlib.sha256(blob).hexdigest() == MANIFEST[case], case
    y = temporal.decompress_chain(blob, device="cpu")
    loose = ADAPTIVE_LOOSE if adaptive == "tda" else 1.0
    for t, f in enumerate(frames):
        bound = EB * loose * (float(f.max()) - float(f.min()))
        assert np.abs(f.astype(np.float64) - y[t].astype(np.float64)).max() <= bound


@pytest.mark.parametrize("case", ["chain/advect/turbulence/float64",
                                  "chain-adaptive/diffuse/float32"])
def test_chain_manifest_hashes_under_another_solver(case):
    frames, adaptive = _chain_frames(case)
    blob = temporal.compress_chain(frames, EB, keyframe_interval=CHAIN_INTERVAL,
                                   adaptive_eb=adaptive, solver="frontier",
                                   device="cpu")
    assert hashlib.sha256(blob).hexdigest() == MANIFEST[case], case


@pytest.mark.parametrize("name,fname", [("v2", "fixture_v2.lopc"),
                                        ("v2_wide", "fixture_v2_wide.lopc"),
                                        ("v2_adaptive", "fixture_v2_adaptive.lopc")])
def test_v2_fixtures_decode_to_expected(name, fname):
    want = np.load(DATA / "expected.npz")[name]
    got = engine.decompress((DATA / fname).read_bytes(), device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
