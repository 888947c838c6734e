"""Region-of-interest reads of the port against the JAX reference, on the
CPU: ``decompress_roi`` equals the reference's bit for bit on every rank
(order-preserving and plain containers, empty, reversed, negative and
clamped slices, non-finite cells), decodes exactly the tiles that
``tiles_for_region`` names, and ``decode_tiles_many`` batches tiles
across containers.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro import engine as ref_engine
from repro.engine import plan as ref_plan
from repro_torch import engine as pt_engine
from repro_torch.core import bitstream
from repro_torch.data.fields import make_scientific_field
from repro_torch.engine import executor as pt_executor

PLAN = dict(tile_shape=(4, 4, 8))

FIELDS = {
    "3d-f32": (lambda: make_scientific_field("turbulence", (13, 11, 17), np.float32, seed=1),
               [(slice(2, 11), slice(3, 9), slice(5, 16)),    # crosses tiles
                (slice(5, 7), slice(1, 3), slice(9, 14)),     # inside one tile
                (slice(6, 7), slice(None), slice(None)),      # one-cell slab
                (slice(-5, None), slice(-20, 4), slice(10, 999)),  # negative, clamped
                (slice(9, 2), slice(0, 5), slice(0, 5)),      # reversed: empty
                (slice(3, 3), slice(0, 2), slice(0, 8))]),    # empty
    "2d-f64": (lambda: make_scientific_field("waves", (26, 44), np.float64, seed=2),
               [(slice(3, 19), slice(40, 44)), (slice(-7, -1), slice(None, 5)),
                (slice(0, 26), slice(12, 13)), (slice(30, 40), slice(0, 3))]),
    "1d-f32": (lambda: make_scientific_field("front", (700,), np.float32, seed=3),
               [(slice(100, 600),), (slice(-50, None),), (slice(5, 6),),
                (slice(400, 300),)]),
}


@pytest.mark.parametrize("order", [True, False])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_roi_equals_reference_and_full_crop(name, order):
    make, regions = FIELDS[name]
    x = make()
    plan = pt_engine.CompressionPlan(**PLAN) if x.ndim == 3 else None
    rplan = ref_engine.CompressionPlan(**PLAN) if x.ndim == 3 else None
    blob = pt_engine.compress(x, 1e-2, preserve_order=order, plan=plan,
                              device="cpu")
    assert blob == ref_engine.compress(x, 1e-2, preserve_order=order,
                                       solver="blockwise", plan=rplan)
    full = pt_engine.decompress(blob, plan=plan, device="cpu")
    c = bitstream.read_container_v2(blob)
    layout = pt_engine.container_layout(c)
    for region in regions:
        pt_executor.reset_decode_counts()
        got = pt_engine.decompress_roi(blob, region, plan=plan, device="cpu")
        want = ref_engine.decompress_roi(blob, region, plan=rplan)
        assert got.dtype == want.dtype and got.shape == want.shape, region
        assert got.tobytes() == want.tobytes(), region
        assert got.tobytes() == np.ascontiguousarray(full[region]).tobytes()
        ids = pt_engine.tiles_for_region(layout, region)
        assert ids == ref_plan.tiles_for_region(layout, region)
        assert pt_executor.DECODE_COUNTS["tiles"] == len(ids), region
        assert pt_executor.DECODE_COUNTS["batches"] == (1 if ids else 0)


@pytest.mark.parametrize("order", [True, False])
def test_roi_nonfinite_cells(order):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20, 15, 10))
    x[rng.random(x.shape) < 0.05] = np.nan
    x[3, 3, 3] = np.inf
    x[0, 14, 9] = -np.inf
    blob = pt_engine.compress(x, 1e-2, preserve_order=order, device="cpu")
    full = pt_engine.decompress(blob, device="cpu")
    for region in [(slice(0, 8), slice(2, 15), slice(3, 9)),
                   (slice(-3, None), slice(10, None), slice(None))]:
        got = pt_engine.decompress_roi(blob, region, device="cpu")
        want = ref_engine.decompress_roi(blob, region)
        assert got.tobytes() == want.tobytes()
        assert np.array_equal(got, full[region], equal_nan=True)


def test_roi_region_checks():
    x = make_scientific_field("waves", (12, 10, 8), np.float32, seed=5)
    blob = pt_engine.compress(x, 1e-2, device="cpu")
    with pytest.raises(ValueError, match="step 1"):
        pt_engine.decompress_roi(blob, (slice(0, 4, 2), slice(0, 5),
                                        slice(0, 5)), device="cpu")
    with pytest.raises(ValueError, match="step 1"):  # even on an empty axis
        pt_engine.decompress_roi(blob, (slice(3, 3), slice(0, 5, 3),
                                        slice(0, 5)), device="cpu")
    with pytest.raises(ValueError, match="2 slices"):
        pt_engine.decompress_roi(blob, (slice(0, 4), slice(0, 5)),
                                 device="cpu")
    with pytest.raises(ValueError, match="decode path"):
        pt_engine.decompress_roi(blob, (slice(0, 4),) * 3,
                                 decode_path="nope", device="cpu")


def test_decode_tiles_many_across_containers():
    a = make_scientific_field("gaussians", (13, 11, 17), np.float32, seed=6)
    b = make_scientific_field("turbulence", (9, 12, 16), np.float32, seed=7)
    c64 = make_scientific_field("front", (40, 28), np.float64, seed=8)
    plan = pt_engine.CompressionPlan(**PLAN)
    rplan = ref_engine.CompressionPlan(**PLAN)
    blobs = [pt_engine.compress(a, 1e-2, plan=plan, device="cpu"),
             pt_engine.compress(b, 1e-2, preserve_order=False, plan=plan,
                                device="cpu"),
             pt_engine.compress(b, 2e-2, plan=plan, device="cpu"),
             pt_engine.compress(c64, 1e-2, plan=plan, device="cpu")]
    runs = [(blobs[0], [0, 5, 7]), (blobs[1], [3, 1]), (blobs[2], [2, 3, 4]),
            (blobs[3], []), (blobs[0], [1])]
    pt_executor.reset_decode_counts()
    got = pt_engine.decode_tiles_many(runs, plan=plan, device="cpu")
    want = ref_engine.decode_tiles_many(runs, plan=rplan)
    assert len(got) == len(want) == len(runs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert pt_executor.DECODE_COUNTS["tiles"] == 9
    # one batch per (dtype, tile, order, words) signature: ordered f32
    # (containers 0 and 2 share it) and plain f32
    assert pt_executor.DECODE_COUNTS["batches"] == 2
    single = pt_engine.decode_tiles_for_region(blobs[2], [2, 3, 4],
                                               plan=plan, device="cpu")
    assert single.tobytes() == got[2].tobytes()
