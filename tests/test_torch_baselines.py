"""The port's comparison codecs (``repro_torch.codecs.baselines``)
against the reference's (``repro.codecs.baselines``) on the CPU.

The same fields, made from seeds with numpy, go through both packages:
every codec's blob must be equal byte for byte and its decode bit for
bit, on f32 and f64 fields of 1, 2 and 3 dimensions, and every lossy
codec must hold its point-wise bound.  ``lossless_fp_decode`` must give
the field back exactly, from either package's blob.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.codecs import baselines as ref
from repro_torch.codecs import baselines as pt
from repro_torch.data.fields import make_scientific_field

EB = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {
    "turbulence-3d": ("turbulence", (18, 20, 22)),
    "gaussians-2d": ("gaussians", (40, 36)),
    "waves-1d": ("waves", (5000,)),
}


def _field(case: str, dtype: str) -> np.ndarray:
    name, shape = FIELDS[case]
    return make_scientific_field(name, shape, np.dtype(dtype), seed=3)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


LOSSY = ("pfpl_lite", "sz_lorenzo", "topoqz_lite")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(FIELDS))
@pytest.mark.parametrize("codec", LOSSY)
def test_lossy_codec_equals_reference(codec, case, dtype):
    x = _field(case, dtype)
    want = getattr(ref, codec)(x, EB)
    got = getattr(pt, codec)(x, EB, device="cpu")
    assert got.blob == want.blob
    assert _same(got.decoded, np.asarray(want.decoded))
    assert got.raw_bytes == want.raw_bytes and got.ratio == want.ratio
    bound = EB * (float(x.max()) - float(x.min()))
    err = np.abs(x.astype(np.float64) - got.decoded.astype(np.float64)).max()
    assert err <= bound


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(FIELDS))
def test_lossless_codecs_equal_reference(case, dtype):
    x = _field(case, dtype)
    want, got = ref.lossless_fp(x), pt.lossless_fp(x, device="cpu")
    assert got.blob == want.blob and _same(got.decoded, x)
    for blob in (got.blob, want.blob):
        assert _same(pt.lossless_fp_decode(blob, device="cpu"), x)
    assert _same(np.asarray(ref.lossless_fp_decode(got.blob)), x)
    assert pt.zstd_raw(x).blob == ref.zstd_raw(x).blob


def test_sz_lorenzo_wraps_in_the_bins_width():
    """A checkerboard of +-1 at a bound whose bins (+-2e9) just fit int32:
    the Lorenzo residuals leave int32 range and wrap, and the restore
    must wrap back in int32, as the reference's ``cumsum(...,
    dtype=int32)`` does."""
    x = np.where(np.indices((32, 48)).sum(0) % 2, 1.0, -1.0).astype(np.float32)
    q = pt._bins(x, 2.5e-10 * (1 - 2.0**-20), "cpu")
    assert q.dtype == torch.int32 and int(q.abs().max()) > 2**30
    want = ref.sz_lorenzo(x, 2.5e-10, "abs")
    got = pt.sz_lorenzo(x, 2.5e-10, "abs", device="cpu")
    assert got.blob == want.blob
    assert _same(got.decoded, np.asarray(want.decoded))
    assert np.abs(got.decoded - x).max() <= 2.5e-10


def test_topoqz_pins_the_extrema():
    x = _field("turbulence-3d", "float32")
    from repro_torch.tda import classify_critical_points

    got = pt.topoqz_lite(x, EB, device="cpu")
    cls = classify_critical_points(x, device="cpu").numpy()
    pin = (cls == 1) | (cls == 2)
    assert pin.any() and np.array_equal(got.decoded[pin], x[pin])
    assert len(got.blob) == len(pt.pfpl_lite(x, EB, device="cpu").blob) \
        + int(pin.sum()) * 8
