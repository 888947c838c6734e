"""The port's temporal chains (``repro_torch.temporal``) against the JAX
reference on the CPU.

The same frames, made from seeds with numpy, go through
``repro.temporal`` and ``repro_torch.temporal`` (``device="cpu"``): the
v3 containers must be equal byte for byte and the decoded frames bit for
bit.  The cases cover f32 and f64, 1-D/2-D/3-D frames, the plain path, a
NaN frame at a residual position, keyframe intervals 0, 1 and 2, an
adaptive chain, and two chains of different shapes in one
``compress_chains`` call.  The reference's blobs are built once per
module, at the determinism manifest's small shapes.  The port alone is
held to its own contracts: appended frames, random access, the transfer
counts, ROI reads and the committed v3 fixtures.
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import temporal as ref_temporal
from repro.data.fields import make_field_sequence
from repro.engine import device as ref_device
from repro_torch import engine, temporal
from repro_torch.core import bitstream
from repro_torch.core.quantize import effective_eps
from repro_torch.engine import device as pt_device
from repro_torch.engine import executor
from repro_torch.kernels import fused_decode, fused_encode

DATA = Path(__file__).resolve().parent / "data"
EB = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and a
    pool of threads in each of several test worker processes
    oversubscribes the cores, where a chain compress ran 50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(evo, base, shape, n, dtype, seed):
    return make_field_sequence(evo, base, shape, n, np.dtype(dtype), seed)


def _nan_frames():
    frames = _seq("advect", "gaussians", (13, 11, 9), 5, "float64", 12)
    frames[2] = frames[2].copy()
    frames[2][3:5, 2:4, 1] = np.nan
    frames[3] = frames[3].copy()
    frames[3][0, 0, 0] = np.inf
    return frames


# (frames per chain, compress_chains keywords): each case is one call
CASES = {
    "f32-3d-interval-2": (
        [_seq("advect", "gaussians", (13, 11, 9), 5, "float32", 5)],
        {"keyframe_interval": 2}),
    "f64-2d-interval-0": (
        [_seq("diffuse", "turbulence", (40, 28), 4, "float64", 6)],
        {"keyframe_interval": 0}),
    "f32-1d-interval-1": (
        [_seq("advect", "waves", (500,), 4, "float32", 7)],
        {"keyframe_interval": 1}),
    "f64-3d-plain": (
        [_seq("diffuse", "gaussians", (13, 11, 9), 4, "float64", 8)],
        {"keyframe_interval": 2, "preserve_order": False}),
    "f64-nan-residual": ([_nan_frames()], {"keyframe_interval": None}),
    "f32-adaptive": (
        [_seq("advect", "gaussians", (17, 14, 12), 4, "float32", 9)],
        {"keyframe_interval": 2, "adaptive_eb": "tda"}),
    "two-chains": (
        [_seq("advect", "turbulence", (13, 11, 9), 4, "float32", 10),
         _seq("diffuse", "gaussians", (40, 28), 3, "float64", 11)],
        {"keyframe_interval": 2}),
}


@pytest.fixture(scope="module")
def reference():
    """Each case's reference blobs and decoded chains, built once."""
    out = {}
    for name, (chains, kw) in CASES.items():
        blobs = ref_temporal.compress_chains(chains, EB, **kw)
        out[name] = [(b, ref_temporal.decompress_chain(b)) for b in blobs]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_chain_bytes_and_decode_equal_reference(reference, name):
    chains, kw = CASES[name]
    blobs, stats = temporal.compress_chains(chains, EB, return_stats=True,
                                            device="cpu", **kw)
    for blob, st, frames, (want, want_y) in zip(blobs, stats, chains,
                                                reference[name]):
        assert blob == want
        got = temporal.decompress_chain(blob, device="cpu")
        assert got.dtype == want_y.dtype and got.shape == want_y.shape
        assert got.tobytes() == want_y.tobytes()
        assert st.total_bytes == len(blob) and st.n_frames == len(frames)
        assert st.bins_bytes + st.subbin_bytes + st.header_bytes == len(blob)


def test_nan_frame_restores_and_random_access(reference):
    blob, out = reference["f64-nan-residual"][0]
    c = bitstream.read_container_v3(blob)
    assert c.entries[2].kind == bitstream.FRAME_RESIDUAL
    assert np.isnan(out[2][3:5, 2:4, 1]).all() and out[3][0, 0, 0] == np.inf
    for t in range(c.n_frames):
        got = temporal.decompress_frame(blob, t, device="cpu")
        assert got.tobytes() == out[t].tobytes(), t


def test_decompress_frame_replays_from_the_keyframe_before(reference,
                                                           monkeypatch):
    blob, out = reference["f32-3d-interval-2"][0]
    steps = []
    step = temporal.ChainDecoder.step

    def counted(self, t):
        steps.append(t)
        return step(self, t)

    monkeypatch.setattr(temporal.ChainDecoder, "step", counted)
    for t in range(5):
        steps.clear()
        got = temporal.decompress_frame(blob, t, device="cpu")
        assert got.tobytes() == out[t].tobytes(), t
        assert steps == list(range(t - t % 2, t + 1))
    with pytest.raises(ValueError, match="out of range"):
        temporal.decompress_frame(blob, 5, device="cpu")


@pytest.mark.parametrize("t", [3, 4])  # a residual frame, then a keyframe
def test_appended_frame_equals_the_chains_sections(reference, t):
    blob, _ = reference["f32-3d-interval-2"][0]
    frames = CASES["f32-3d-interval-2"][0][0]
    c = bitstream.read_container_v3(blob)
    dec = temporal.ChainDecoder(c, device="cpu")
    for k in range(t):
        dec.step(k)
    prev = dec.resident_bins()
    assert prev.shape == (dec.layout.n_tiles,) + dec.layout.tile
    eps_abs = c.header.eps_abs
    prev_max = float(np.max(np.abs(frames[t - 1]))) / effective_eps(eps_abs) + 4
    sections, nonfinite, _, _ = temporal.encode_appended_frame(
        frames[t], eps_abs=eps_abs, kind=c.entries[t].kind, prev_bins=prev,
        prev_max_bin=prev_max, device="cpu")
    assert nonfinite is None
    assert sections == c.frame_tiles(t)[0]


def test_appended_frame_of_an_adaptive_chain(reference):
    blob, _ = reference["f32-adaptive"][0]
    frames = CASES["f32-adaptive"][0][0]
    c = bitstream.read_container_v3(blob)
    dec = temporal.ChainDecoder(c, device="cpu")
    dec.step(0)
    eps_tight = effective_eps(c.header.eps_abs) * 2.0**-bitstream.EB_LADDER_K_MAX
    sections, _, _, _ = temporal.encode_appended_frame(
        frames[1], eps_abs=c.header.eps_abs, kind=bitstream.FRAME_RESIDUAL,
        prev_bins=dec.resident_bins(),
        prev_max_bin=float(np.max(np.abs(frames[0]))) / eps_tight + 4,
        ladder=c.eb_ladder(), device="cpu")
    assert sections == c.frame_tiles(1)[0]


@pytest.mark.parametrize("encode_path", ["staged", "fused"])
def test_compress_transfers_one_upload_download_per_frame_per_group(
        encode_path):
    chains, kw = CASES["two-chains"]
    executor.reset_transfer_counts()
    temporal.compress_chains(chains, EB, encode_path=encode_path,
                             device="cpu", **kw)
    # one group per chain (their dtypes differ) and frame: 4 + 3 steps
    assert executor.TRANSFER_COUNTS["h2d_tiles"] == 7
    assert executor.TRANSFER_COUNTS["d2h_sections"] == 7
    assert executor.TRANSFER_COUNTS["d2h_values"] == 0


def test_region_reads_of_chains():
    frames = CASES["f32-3d-interval-2"][0][0]
    one = temporal.compress_chain(frames[:1], EB, device="cpu")
    region = (slice(2, 9), slice(None), slice(3, 5))
    full = temporal.decompress_chain(one, device="cpu")[0]
    got = engine.decompress_roi(one, region, device="cpu")
    assert got.tobytes() == np.ascontiguousarray(full[region]).tobytes()
    two = temporal.compress_chain(frames[:2], EB, device="cpu")
    with pytest.raises(ValueError, match="2 frames"):
        engine.decompress_roi(two, region, device="cpu")


@pytest.mark.parametrize("name", ["v3", "v3_adaptive"])
def test_v3_fixtures_decode_to_expected(name):
    from repro_torch import core

    want = np.load(DATA / "expected.npz")[name]
    blob = (DATA / f"fixture_{name}.lopc").read_bytes()
    got = temporal.decompress_chain(blob, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert core.decompress(blob, device="cpu").tobytes() == want.tobytes()


@pytest.mark.parametrize("transform", ["delta", "zigzag", "raw"])
@pytest.mark.parametrize("word", [2, 4, 8])
def test_decode_tiles_matches_reference(rng, transform, word):
    """The chain's torch decode gives the encoded ints back: the bins
    (delta, zigzag) sign-extended to the int64 bins of f64 fields, the
    subbins (raw) in their own width; at 16 bits, where the extension
    matters, it equals the reference's XLA decode too."""
    sdt = {2: np.int16, 4: np.int32, 8: np.int64}[word]
    u = {2: np.uint16, 4: np.uint32, 8: np.uint64}[word]
    info = np.iinfo(sdt)
    ints = rng.integers(-300, 300, (3, 5000)).astype(sdt)
    ints[1, ::9] = info.min
    ints[2, 1::11] = info.max
    ints[0, :2000] = 0
    bm, words, _ = fused_encode.encode_ints_plain(torch.from_numpy(ints),
                                                  16384 // word, transform)
    # the container's form: each row's nonzero words front-packed
    rows = words.numpy()
    packed = np.zeros_like(rows)
    for r, row in enumerate(rows):
        nz = row[row != 0]
        packed[r, : nz.size] = nz
    out = (torch.int64, jnp.int64) if transform != "raw" else (
        torch.from_numpy(ints).dtype, jnp.dtype(sdt))
    got = pt_device.decode_tiles(bm, torch.from_numpy(packed), 5000,
                                 transform, out[0])
    assert got.dtype == out[0]
    assert np.array_equal(got.numpy(), ints)
    if word == 2:
        want = ref_device.decode_tiles(jnp.asarray(bm.numpy().view(u)),
                                       jnp.asarray(packed.view(u)), 5000,
                                       transform, out[1])
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_decode_refuses_an_unknown_transform():
    bm, words, _ = fused_encode.encode_ints_plain(
        torch.zeros((1, 8192), dtype=torch.int16), 8192, "raw")
    with pytest.raises(ValueError, match="unknown transform"):
        fused_decode.expand_ints(bm, words, 1, 8192, "bogus")
    with pytest.raises(ValueError, match="unknown transform"):
        pt_device.decode_tiles(bm, words, 8192, "delta2", torch.int32)
    with pytest.raises(ValueError, match="unknown transform"):
        fused_encode.encode_ints_plain(torch.zeros((1, 8), dtype=torch.int16),
                                       8192, "bogus")


def test_chain_arguments():
    a = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError, match="at least one frame"):
        temporal.compress_chain([], EB, device="cpu")
    with pytest.raises(ValueError, match="share one shape and dtype"):
        temporal.compress_chain([a, a.astype(np.float64)], EB, device="cpu")
    with pytest.raises(ValueError, match="keyframe_interval"):
        temporal.compress_chain([a], EB, keyframe_interval=-1, device="cpu")
    with pytest.raises(ValueError, match="solver"):
        temporal.compress_chain([a], EB, solver="nope", device="cpu")
    assert temporal.compress_chains([], EB, device="cpu") == []
    for kw, row in [({"put": lambda x: x}, "row 13"),
                    ({"group_cb": print}, "row 12")]:
        with pytest.raises(NotImplementedError, match=row):
            temporal.compress_chains([[a]], EB, device="cpu", **kw)
