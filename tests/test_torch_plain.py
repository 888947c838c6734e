"""The port's plain path (``preserve_order=False``) and its compacted
compress download against the JAX reference, on the CPU: plain
containers equal ``repro.engine.compress(..., preserve_order=False)``
byte for byte, decoded values equal bit for bit, every ``encode_path``
gives the same bytes, and the fused download stays near the payload's
size.  Also pins ``repro_torch/data/plain_hashes.json``, the JAX-free
oracle of the plain path, to the live reference and to the port.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import engine as ref_engine
from repro_torch import engine as pt_engine
from repro_torch.core import bitstream
from repro_torch.data.fields import FIELD_GENERATORS, make_scientific_field
from repro_torch.engine import executor as pt_executor

PLAIN_HASHES = json.loads(
    (Path(pt_engine.__file__).resolve().parents[1] / "data"
     / "plain_hashes.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and a
    pool of threads in each of several test worker processes
    oversubscribes the cores (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nonfinite(shape, dtype, seed):
    x = make_scientific_field("waves", shape, dtype, seed=seed).copy()
    flat = x.reshape(-1)
    flat[3] = np.nan
    flat[flat.size // 2] = np.inf
    flat[-2] = -np.inf
    return x


# (field, eb, mode, bins section width in bytes)
CASES = {
    "3d-f32-noa": (lambda: make_scientific_field("gaussians", (13, 11, 9), np.float32, seed=1), 1e-2, "noa", 2),
    "3d-f64-abs-int32": (lambda: make_scientific_field("turbulence", (12, 10, 8), np.float64, seed=2), 1e-6, "abs", 4),
    "2d-f32-abs-int32": (lambda: make_scientific_field("front", (40, 28), np.float32, seed=3), 1e-6, "abs", 4),
    "2d-f64-noa": (lambda: make_scientific_field("waves", (37, 29), np.float64, seed=4), 1e-2, "noa", 2),
    "1d-f32-noa-int32": (lambda: make_scientific_field("gaussians", (700,), np.float32, seed=5), 1e-6, "noa", 4),
    "1d-f64-abs": (lambda: make_scientific_field("front", (500,), np.float64, seed=6), 5e-2, "abs", 2),
    "3d-f32-nonfinite": (lambda: _nonfinite((11, 9, 10), np.float32, 7), 1e-2, "noa", 2),
    "2d-f64-nonfinite": (lambda: _nonfinite((30, 21), np.float64, 8), 1e-3, "noa", 2),
}


def _bound(x, eb, mode):
    fin = x[np.isfinite(x)]
    return eb if mode == "abs" else eb * (float(fin.max()) - float(fin.min()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_containers_and_values_equal_reference(case):
    make, eb, mode, word = CASES[case]
    x = make()
    want, want_stats = ref_engine.compress(x, eb, mode=mode,
                                           preserve_order=False,
                                           return_stats=True)
    for path in ("staged", "fused"):
        got, got_stats = pt_engine.compress(
            x, eb, mode=mode, preserve_order=False, encode_path=path,
            return_stats=True, device="cpu")
        assert got == want, path
        assert got_stats == pt_engine.CompressStats(**vars(want_stats))
    c = bitstream.read_container_v2(got)
    assert c.header.flags & bitstream.FLAG_ORDER_PRESERVING == 0
    assert c.stream_words() == (word, 0)
    y_ref = ref_engine.decompress(want)
    y = pt_engine.decompress(got, device="cpu")
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.tobytes() == y_ref.tobytes()
    fin = np.isfinite(x)
    assert np.array_equal(np.isfinite(y), fin)
    err = np.abs(y[fin].astype(np.float64) - x[fin].astype(np.float64))
    assert err.max() <= _bound(x, eb, mode)


def test_plain_compress_many_mixes_shapes_and_dtypes():
    fields = [make_scientific_field("waves", (13, 11, 9), np.float32, seed=21),
              make_scientific_field("front", (40, 28), np.float64, seed=8),
              make_scientific_field("turbulence", (300,), np.float32, seed=9),
              make_scientific_field("gaussians", (9, 9, 9), np.float32, seed=10)]
    ebs = [1e-2, 1e-3, 1e-2, 5e-3]
    want = ref_engine.compress_many(fields, ebs, preserve_order=False)
    got = pt_engine.compress_many(fields, ebs, preserve_order=False,
                                  encode_path="fused", device="cpu")
    assert got == want
    for y, r in zip(pt_engine.decompress_many(got, device="cpu"),
                    ref_engine.decompress_many(want)):
        assert y.tobytes() == r.tobytes()


@pytest.mark.parametrize("order", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode_paths_give_the_same_bytes(dtype, order):
    x = make_scientific_field("turbulence", (20, 18, 16), dtype, seed=12)
    blobs = {path: pt_engine.compress(x, 1e-2, preserve_order=order,
                                      encode_path=path, device="cpu")
             for path in ("staged", "fused", "auto")}
    assert blobs["fused"] == blobs["staged"] == blobs["auto"]
    assert blobs["staged"] == ref_engine.compress(
        x, 1e-2, preserve_order=order, solver="blockwise")


def test_fused_download_is_near_payload_size():
    """The reference's transfer test (``test_executor.py``): a fused
    compress downloads at most 1.1x the container; the staged one more."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal((40, 40, 40)), axis=0).astype(np.float32)
    pt_executor.reset_transfer_counts()
    blob = pt_engine.compress(x, 1e-3, encode_path="fused", device="cpu")
    d2h = pt_executor.TRANSFER_COUNTS["bytes_d2h"]
    assert 0 < d2h <= 1.1 * len(blob), (d2h, len(blob))
    assert pt_executor.TRANSFER_COUNTS["d2h_aux"] == 2  # sub max + totals
    pt_executor.reset_transfer_counts()
    staged = pt_engine.compress(x, 1e-3, encode_path="staged", device="cpu")
    assert staged == blob
    assert pt_executor.TRANSFER_COUNTS["bytes_d2h"] > d2h
    assert blob == ref_engine.compress(x, 1e-3)


@pytest.mark.parametrize("shape", [(13, 11, 9), (40, 28), (500,)])
def test_value_encode_gets_contiguous_interiors(monkeypatch, shape):
    """The fused value encode's kernel takes contiguous operands only;
    for 1-D and 2-D tiles the interior reshape alone is a strided view."""
    from repro_torch.engine import device as pt_device

    seen = []
    real = pt_device.encode_values_fused

    def spy(x_int, *args):
        seen.append(x_int.is_contiguous())
        return real(x_int, *args)

    monkeypatch.setattr(pt_device, "encode_values_fused", spy)
    x = make_scientific_field("waves", shape, np.float32, seed=13)
    blob = pt_engine.compress(x, 1e-2, preserve_order=False,
                              encode_path="fused", device="cpu")
    assert seen == [True]
    assert blob == ref_engine.compress(x, 1e-2, preserve_order=False)


def test_encode_path_auto_stays_staged_on_the_cpu():
    assert not pt_executor.use_fused_encode("auto", 1 << 30, on_cuda=False)
    assert pt_executor.use_fused_encode("auto", 1 << 20, on_cuda=True)
    assert not pt_executor.use_fused_encode("auto", (1 << 20) - 1, on_cuda=True)
    assert pt_executor.use_fused_encode("fused", 1, on_cuda=False)
    assert not pt_executor.use_fused_encode("staged", 1 << 30, on_cuda=True)


def test_plain_path_argument_checks():
    x = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    with pytest.raises(ValueError, match="encode path"):
        pt_engine.compress(x, 1e-2, encode_path="nope", device="cpu")
    with pytest.raises(ValueError, match="adaptive_eb mode"):
        pt_engine.compress(x, 1e-2, adaptive_eb="nope", device="cpu")
    blob = pt_engine.compress(x, 1e-2, preserve_order=False, device="cpu")
    with pytest.raises(ValueError, match="decode path"):
        pt_engine.decompress(blob, decode_path="nope", device="cpu")
    for path in ("staged", "fused", "auto"):
        assert (pt_engine.decompress(blob, decode_path=path, device="cpu")
                .tobytes() == ref_engine.decompress(blob).tobytes())


@pytest.mark.parametrize("name", sorted(FIELD_GENERATORS))
def test_plain_hashes_match_reference_and_port(name):
    """``plain_hashes.json`` holds the SHA-256 of the reference's plain
    containers of the 24 manifest snapshot cases (seed 5, eb 1e-2 NOA)."""
    for shape in ((13, 11, 9), (40, 28), (500,)):
        for dtype in ("float32", "float64"):
            case = f"{name}/{'x'.join(map(str, shape))}/{dtype}"
            x = make_scientific_field(name, shape, np.dtype(dtype), seed=5)
            want = ref_engine.compress(x, 1e-2, preserve_order=False)
            got = pt_engine.compress(x, 1e-2, preserve_order=False,
                                     device="cpu")
            assert hashlib.sha256(want).hexdigest() == PLAIN_HASHES[case], case
            assert got == want, case
    assert len(PLAIN_HASHES) == 24
