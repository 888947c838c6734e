"""The whole-field (v1) compressor of the port against the JAX reference,
on the CPU: ``repro_torch.core.compress(..., container_version=1)``
bytes equal ``repro.core.compress(..., container_version=1)`` bytes,
``CompressStats`` are equal (``n_sweeps`` under the same schedule),
decodes are equal bit for bit, containers cross both ways, and the v1
decode equals the tiled (v2) decode of the same field: the parity claim.

Cases: the 24 snapshot cases of ``benchmarks/check_determinism.py``
(generators x shapes x dtypes, eb 1e-2 NOA), plus the plain path, an
ABS bound, a non-finite sidecar and 1-D/2-D fields.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as ref_core
from benchmarks.check_determinism import DTYPES, EB, SHAPES
from repro.data.fields import FIELD_GENERATORS
from repro_torch import core as pt_core
from repro_torch.data.fields import make_scientific_field

SNAPSHOT = [(name, shape, dtype) for name in sorted(FIELD_GENERATORS)
            for shape in SHAPES for dtype in DTYPES]
IDS = [f"{n}/{'x'.join(map(str, s))}/{d}" for n, s, d in SNAPSHOT]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and a
    pool of threads in each of several test worker processes
    oversubscribes the cores (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(name, shape, dtype):
    return make_scientific_field(name, shape, np.dtype(dtype), seed=5)


def _check_against_reference(x, eb, **kw):
    """Bytes, stats and decodes equal both ways; returns the port's blob."""
    want, want_stats = ref_core.compress(x, eb, container_version=1,
                                         return_stats=True, **kw)
    got, got_stats = pt_core.compress(x, eb, container_version=1,
                                      return_stats=True, device="cpu", **kw)
    assert got[4] == 1
    assert got == want
    assert got_stats == pt_core.CompressStats(**vars(want_stats))
    y_ref = ref_core.decompress(want)
    y = pt_core.decompress(want, device="cpu")  # the reference's container
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.tobytes() == y_ref.tobytes()
    assert ref_core.decompress(got).tobytes() == y_ref.tobytes()
    return got, y


@pytest.mark.parametrize("name,shape,dtype", SNAPSHOT, ids=IDS)
def test_v1_containers_equal_reference(name, shape, dtype):
    x = _field(name, shape, dtype)
    _, y = _check_against_reference(x, EB)  # solver="auto": jacobi here
    bound = EB * (float(x.max()) - float(x.min()))
    assert np.abs(y.astype(np.float64) - x.astype(np.float64)).max() <= bound
    _check_against_reference(x, EB, solver="blockwise")


@pytest.mark.parametrize("name,shape,dtype", SNAPSHOT, ids=IDS)
def test_v1_decode_equals_tiled_decode(name, shape, dtype):
    """The parity claim: decompress(compress(x)) (v2, tiled) equals
    decompress(compress(x, container_version=1)) bit for bit."""
    x = _field(name, shape, dtype)
    v1 = pt_core.compress(x, EB, container_version=1, device="cpu")
    v2 = pt_core.compress(x, EB, device="cpu")
    assert v1[4] == 1 and v2[4] == 2
    assert np.array_equal(pt_core.decompress(v1, device="cpu"),
                          pt_core.decompress(v2, device="cpu"))


OTHER_CASES = {
    "plain-3d-f32": (lambda r: _field("turbulence", (13, 11, 9), "float32"), 1e-2,
                     {"preserve_order": False}),
    "plain-1d-f64": (lambda r: _field("waves", (500,), "float64"), 1e-2,
                     {"preserve_order": False}),
    "abs-3d-f64": (lambda r: _field("gaussians", (13, 11, 9), "float64"), 5e-3,
                   {"mode": "abs"}),
    "abs-2d-f32-frontier": (lambda r: _field("front", (40, 28), "float32"), 2e-2,
                            {"mode": "abs", "solver": "frontier"}),
    "1d-rng-f64": (lambda r: r.standard_normal(777), 1e-2, {}),
    "2d-rng-f32-blockwise": (lambda r: r.standard_normal((19, 31)).astype(np.float32),
                             5e-2, {"solver": "blockwise"}),
    "3d-rng-int32-bins": (lambda r: r.standard_normal((9, 8, 7)).astype(np.float32),
                          1e-6, {}),
}


@pytest.mark.parametrize("case", sorted(OTHER_CASES))
def test_v1_other_paths_equal_reference(rng, case):
    make, eb, kw = OTHER_CASES[case]
    x = make(rng)
    _check_against_reference(x, eb, **kw)
    if kw.get("preserve_order", True) is False:
        v2 = pt_core.compress(x, eb, preserve_order=False, device="cpu")
        v1 = pt_core.compress(x, eb, container_version=1, device="cpu", **kw)
        assert np.array_equal(pt_core.decompress(v1, device="cpu"),
                              pt_core.decompress(v2, device="cpu"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_v1_nonfinite_sidecar_equals_reference(rng, dtype):
    x = rng.standard_normal((11, 10, 9)).astype(dtype)
    x[0, 0, 0] = np.nan
    x[3, 4, 5] = np.inf
    x[7, :, 2] = -np.inf
    x[10, 9, 8] = np.float64(np.nan).astype(dtype)
    _, y = _check_against_reference(x, 1e-2)
    assert np.array_equal(np.isfinite(y), np.isfinite(x))
    mask = ~np.isfinite(x)
    assert y[mask].tobytes() == x[mask].tobytes()


def test_compression_ratio_equals_reference():
    x = _field("waves", (13, 11, 9), "float32")
    want = ref_core.compression_ratio(x, EB, container_version=1)
    got = pt_core.compression_ratio(x, EB, container_version=1, device="cpu")
    assert got == want > 1.0


@pytest.mark.parametrize("args,kw", [
    ((np.zeros((4, 4), np.int32), 1e-2), {}),                 # dtype
    ((np.zeros((2, 2, 2, 2), np.float32), 1e-2), {}),         # ndim 4
    ((np.ones((4, 4), np.float32), 0.0), {}),                 # eb <= 0
    ((np.ones((4, 4), np.float32), -1.0), {}),
    ((np.linspace(0, 1e-30, 16, dtype=np.float32), 1e-12), {}),  # FTZ guard
    ((np.array([1e30, -1e30], np.float32), 1e-12), {}),        # bin range
    ((np.ones(8), 1e-2), {"container_version": 7}),            # version
])
def test_v1_errors_equal_reference(args, kw):
    kw = {"container_version": 1, **kw}
    with pytest.raises(ValueError) as ref_err:
        ref_core.compress(*args, **kw)
    with pytest.raises(ValueError) as pt_err:
        pt_core.compress(*args, device="cpu", **kw)
    # the same check fires first in both packages
    assert str(pt_err.value).split()[:3] == str(ref_err.value).split()[:3]


def test_v1_entry_points_refuse_to_run_on_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    x = np.linspace(0, 1, 64, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_core.compress(x, 1e-2, container_version=1)
    blob = pt_core.compress(x, 1e-2, container_version=1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_core.decompress(blob)
