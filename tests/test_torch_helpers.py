"""The reference's small public helpers in the port, against the
reference's values: the bucket tally (``engine.buckets``:
``capacity_classes``, ``record_batch``, ``reset_bucket_counts``,
``pad_waste``) as the executor feeds it, ``executor.decode_count`` and
``transfer_count``, and ``models.inputs.decode_token_specs``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import engine as ref_engine
from repro.engine import buckets as ref_buckets
from repro.engine import executor as ref_executor
from repro.models import inputs as ref_inputs
from repro.models.registry import get_arch as ref_get_arch
from repro_torch import engine
from repro_torch.engine import buckets, executor
from repro_torch.models import get_arch
from repro_torch.models import inputs
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("floor", [1, 4, 8, 12, 64])
def test_capacity_classes_equal_the_reference(floor):
    assert buckets.capacity_classes(floor) == ref_buckets.capacity_classes(floor)
    assert buckets.capacity_classes() == ref_buckets.capacity_classes()


def test_record_batch_and_pad_waste_equal_the_reference():
    batches = [("compress", 3, 8), ("decode", 8, 8), ("compress", 9, 16),
               ("decode", 1, 8)]
    for mod in (buckets, ref_buckets):
        mod.reset_bucket_counts()
        assert mod.pad_waste() == 0.0
        for b in batches:
            mod.record_batch(*b)
    assert buckets.BUCKET_COUNTS == ref_buckets.BUCKET_COUNTS
    assert buckets.PAD_COUNTS == ref_buckets.PAD_COUNTS
    assert buckets.pad_waste() == ref_buckets.pad_waste() == 19 / 21
    buckets.reset_bucket_counts()
    assert not buckets.BUCKET_COUNTS and not buckets.PAD_COUNTS


def test_the_executor_feeds_the_tally_as_the_reference():
    """Two fields of different ranks in one ``compress_many``, then their
    decode: the same device batches by kind and capacity, the same pad
    waste, the same decoded tiles."""
    rng = np.random.default_rng(0)
    fields = [rng.standard_normal(s).astype(np.float32)
              for s in ((40, 100), (3000,))]
    got, want = {}, {}
    for eng, mod, ex, out, kw in (
            (engine, buckets, executor, got, {"device": "cpu"}),
            (ref_engine, ref_buckets, ref_executor, want, {})):
        mod.reset_bucket_counts()
        ex.reset_transfer_counts()
        ex.reset_decode_counts()
        blobs = eng.compress_many(fields, 1e-2, **kw)
        out["compress"] = (dict(mod.BUCKET_COUNTS), dict(mod.PAD_COUNTS))
        out["h2d_tiles"] = ex.transfer_count("h2d_tiles")
        for blob in blobs:
            eng.decompress(blob, **kw)
        out["all"] = (dict(mod.BUCKET_COUNTS), dict(mod.PAD_COUNTS),
                      mod.pad_waste())
        out["tiles"] = ex.decode_count()
        out["batches"] = ex.decode_count("batches")
        assert ex.transfer_count() == sum(ex.TRANSFER_COUNTS.values()) > 0
        assert ex.transfer_count("h2d_tiles", "d2h_aux") == (
            ex.TRANSFER_COUNTS["h2d_tiles"] + ex.TRANSFER_COUNTS["d2h_aux"])
    assert got == want
    assert got["tiles"] > 0 and got["all"][2] > 0


def test_decode_token_specs_equal_the_reference():
    for arch in ("qwen2.5-3b", "mixtral-8x22b"):
        want = ref_inputs.decode_token_specs(ref_get_arch(arch).config, 128)
        got = inputs.decode_token_specs(get_arch(arch).config, 128)
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == torch.int32 and str(want.dtype) == "int32"
