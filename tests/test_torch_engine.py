"""The port's slice as a whole against the JAX reference, on the CPU:
``repro_torch.engine.compress`` bytes equal ``repro.engine.compress``
bytes, ``decompress`` values equal bit for bit, and containers cross
between the two packages in both directions.

The reference runs ``solver="blockwise"``: its tile-local solve is the
Pallas kernel (interpret mode here) whose sweep counts the port's
``CompressStats.n_sweeps`` reproduce.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro import engine as ref_engine
from repro.data.fields import make_scientific_field as ref_field
from repro_torch import engine as pt_engine
from repro_torch.data.fields import make_scientific_field
from repro_torch.engine import executor as pt_executor


# (field, eb, mode): eb >= 1e-2 keeps int16 bins, ~1e-6 reaches int32
# bins, 1e-11 on f64 reaches int64 bins; the loose "chains" bounds put
# long same-bin runs into one bin, so the subbin solve runs 20-30 sweeps
CASES = {
    "3d-f32-noa-chains": (lambda: make_scientific_field("gaussians", (13, 11, 9), np.float32, seed=1), 5e-2, "noa"),
    "3d-f64-noa-int32": (lambda: make_scientific_field("waves", (12, 10, 8), np.float64, seed=2), 1e-6, "noa"),
    "2d-f32-abs": (lambda: make_scientific_field("turbulence", (40, 28), np.float32, seed=3), 2e-2, "abs"),
    "2d-f64-noa-chains": (lambda: make_scientific_field("gaussians", (37, 29), np.float64, seed=1), 0.2, "noa"),
    "1d-f64-noa-int64": (lambda: make_scientific_field("gaussians", (700,), np.float64, seed=5), 1e-11, "noa"),
    "1d-f32-abs-int32": (lambda: make_scientific_field("front", (500,), np.float32, seed=6), 1e-6, "abs"),
    "3d-f32-plan": (lambda: make_scientific_field("front", (10, 9, 17), np.float32, seed=7), 1e-2, "noa"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_and_decompress_equal_reference(case):
    make, eb, mode = CASES[case]
    x = make()
    plan_kw = {}
    if case.endswith("plan"):  # an explicit plan tile: several tiles + halos
        plan_kw = {"plan": pt_engine.CompressionPlan(tile_shape=(4, 4, 8))}
        ref_kw = {"plan": ref_engine.CompressionPlan(tile_shape=(4, 4, 8))}
    else:
        ref_kw = {}
    want, want_stats = ref_engine.compress(x, eb, mode=mode, solver="blockwise",
                                           return_stats=True, **ref_kw)
    got, got_stats = pt_engine.compress(x, eb, mode=mode, return_stats=True,
                                        device="cpu", **plan_kw)
    assert got == want
    assert got_stats == pt_engine.CompressStats(**vars(want_stats))
    if "chains" in case:
        assert got_stats.n_sweeps >= 20
    y_ref = ref_engine.decompress(want, **ref_kw)
    y = pt_engine.decompress(got, device="cpu", **plan_kw)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.tobytes() == y_ref.tobytes()
    bound = eb if mode == "abs" else eb * (float(x.max()) - float(x.min()))
    assert np.abs(y.astype(np.float64) - x.astype(np.float64)).max() <= bound


def test_stream_widths_are_reached():
    """The cases above cover every bins section width.  (An int32 subbin
    section needs a same-bin chain of 2**15 points, i.e. as many Jacobi
    sweeps; the kernel tests cover the int32 raw encode and decode.)"""
    from repro_torch.core import bitstream

    seen = set()
    for case in sorted(CASES):
        make, eb, mode = CASES[case]
        blob = pt_engine.compress(make(), eb, mode=mode, device="cpu")
        seen.add(bitstream.read_container_v2(blob).stream_words())
    assert {w for w, _ in seen} == {2, 4, 8}


def test_nonfinite_cells_and_compress_many_mixed_shapes():
    a = ref_field("waves", (13, 11, 9), np.float32, seed=21).copy()
    a[3, 4, 5] = np.nan
    a[0, 0, 0] = np.inf
    a[5, 1, 2] = -np.inf
    b = make_scientific_field("front", (40, 28), np.float64, seed=8)
    c = make_scientific_field("turbulence", (300,), np.float32, seed=9)
    d = make_scientific_field("gaussians", (9, 9, 9), np.float32, seed=10)
    fields, ebs = [a, b, c, d], [1e-2, 1e-3, 1e-2, 5e-3]
    want = ref_engine.compress_many(fields, ebs, solver="blockwise")
    got = pt_engine.compress_many(fields, ebs, device="cpu")
    assert got == want
    outs = pt_engine.decompress_many(got, device="cpu")
    refs = ref_engine.decompress_many(want)
    for y, r, x in zip(outs, refs, fields):
        assert y.tobytes() == r.tobytes()
    assert np.isnan(outs[0][3, 4, 5]) and outs[0][0, 0, 0] == np.inf


def test_containers_cross_between_packages():
    x = make_scientific_field("waves", (11, 12, 10), np.float64, seed=11)
    ref_blob = ref_engine.compress(x, 0.1, solver="jacobi")
    pt_blob = pt_engine.compress(x, 0.1, device="cpu")
    assert ref_blob == pt_blob
    assert (pt_engine.decompress(ref_blob, device="cpu").tobytes()
            == ref_engine.decompress(pt_blob).tobytes())


def test_one_upload_and_one_download_per_group():
    pt_executor.reset_transfer_counts()
    x = make_scientific_field("waves", (13, 11, 9), np.float32, seed=1)
    pt_engine.compress(x, 1e-2, device="cpu")
    tc = pt_executor.TRANSFER_COUNTS
    assert tc["h2d_tiles"] == 1 and tc["d2h_sections"] == 1
    assert tc["d2h_round"] >= 1 and tc["d2h_aux"] == 1
