"""Topology-adaptive error bounds in the port against the JAX reference,
on the CPU: the ordered-space lane of the tile solve (int32 for f32
fields, int64 for f64) against the reference's Pallas kernel in
interpret mode on its biased unsigned state; ``engine.compress(...,
adaptive_eb="tda")`` byte-equal to the reference for the five stress
families of ``test_order_properties.py`` in f32 and f64 and for a field
whose subbin sections are 8 bytes wide, and the decode bit-equal to the
reference's.  Both lanes' kernels against their plain version, on the
card: tests/test_torch_cuda.py.

Inputs are made from seeds with numpy and handed to both packages.
Every comparison is exact.
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as ref_engine
from repro.core import bitstream as ref_bitstream
from repro.kernels import subbin_sweep as ref_ss
from repro_torch import engine as pt_engine
from repro_torch.core import bitstream as pt_bitstream
from repro_torch.core import topology
from repro_torch.core.floatbits import float_to_ordered
from repro_torch.engine import device as pt_device
from repro_torch.kernels import subbin_sweep as pt_ss

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_order_properties import FAMILIES, make_family  # noqa: E402
from test_torch_tda import staircase  # noqa: E402

EB = 1e-2


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _ordered_batch(rng, dtype, b: int = 3, tile=(2, 4, 8)):
    """A haloed batch of ordered-space states and their all-pairs flags:
    values with SoS ties, each state seeded at the value's floor (as the
    engine seeds it at the decode base below the value), and some cells
    outside the field (+inf values, the neutral ``iinfo.min`` state)."""
    shape = (b,) + tuple(t + 2 for t in tile)
    x = (np.round(rng.standard_normal(shape) * 16) / 16).astype(dtype)
    x[rng.random(shape) < 0.1] = np.inf
    xt = _t(x)
    flags = torch.stack([topology.order_flags_all(xt[i]) for i in range(b)])
    flags = flags[:, 1:-1, 1:-1, 1:-1].contiguous()
    s = float_to_ordered(torch.where(torch.isinf(xt), 0.0, xt.floor()))
    s = torch.where(torch.isinf(xt), torch.iinfo(s.dtype).min, s)
    return s, flags


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ordered_lane_plain_matches_pallas(rng, dtype):
    """The signed-twin state solved by the port's plain version equals
    the reference kernel's unsigned biased state, mapped back: same
    interiors, same per-tile sweep counts."""
    s_h, flags = _ordered_batch(rng, dtype)
    udt, bias = ((np.uint32, np.uint32(1) << np.uint32(31))
                 if dtype == np.float32 else
                 (np.uint64, np.uint64(1) << np.uint64(63)))
    u_h = s_h.numpy().view(udt) ^ bias
    want, want_it = ref_ss.solve_tiles_blockwise(
        jnp.asarray(u_h), jnp.asarray(flags.numpy().view(np.uint32)),
        interpret=True)
    got, got_it = pt_ss.solve_tiles_blockwise(s_h, flags)
    assert got.dtype == s_h.dtype
    assert np.array_equal(got.numpy(), (np.asarray(want) ^ bias).view(got.numpy().dtype))
    assert np.array_equal(got_it.numpy(), np.asarray(want_it))
    assert got_it.max() > 1  # the batch really climbed


def _check_same(x, kw_ref=None, **kw):
    want = ref_engine.compress(x, EB, adaptive_eb="tda", **(kw_ref or {}))
    got = pt_engine.compress(x, EB, adaptive_eb="tda", device="cpu", **kw)
    assert got == want
    y = pt_engine.decompress(got, device="cpu")
    assert y.tobytes() == ref_engine.decompress(want).tobytes()
    return got, y


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_adaptive_compress_matches_reference(family, dtype):
    x = make_family(family, (12, 10, 8), dtype)
    blob, _ = _check_same(x, {"solver": "jacobi"})
    c = pt_bitstream.read_container_v2(blob)
    assert c.header.flags & pt_bitstream.FLAG_ADAPTIVE_EB
    assert np.array_equal(c.eb_ladder(),
                          ref_bitstream.read_container_v2(blob).eb_ladder())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wide_adaptive_subbins_match_reference(dtype):
    """The staircase's leftover anchor inversions climb far in ordered
    space: its f64 subbin sections are 8 bytes wide (kernel 2's w=64
    encode) and decode through the one decode kernel's plain version to
    the reference's staged decode."""
    x = staircase(np.dtype(dtype))
    blob, y = _check_same(x, {"solver": "jacobi"})
    words = pt_bitstream.read_container_v2(blob).stream_words()
    assert words[1] == (8 if dtype == np.float64 else 4)
    assert y.dtype == x.dtype


def test_solver_values_give_the_same_adaptive_bytes():
    x = make_family("noisy", (12, 10, 8), np.float32)
    blobs = {s: pt_engine.compress(x, EB, adaptive_eb="tda", solver=s,
                                   device="cpu")
             for s in ("auto", "jacobi", "frontier", "blockwise")}
    assert len(set(blobs.values())) == 1
    assert blobs["auto"] == ref_engine.compress(x, EB, adaptive_eb="tda",
                                                solver="blockwise")


def test_adaptive_and_uniform_requests_group_apart():
    rng = np.random.default_rng(3)
    fields = [rng.standard_normal((9, 10, 11)).astype(np.float32),
              np.cumsum(rng.standard_normal((300,))).astype(np.float64)]
    for mode in ("off", "tda"):
        want = ref_engine.compress_many(fields, EB, adaptive_eb=mode,
                                        solver="jacobi")
        got = pt_engine.compress_many(fields, EB, adaptive_eb=mode,
                                      device="cpu")
        assert got == want


@pytest.mark.parametrize("dtype,state", [(np.float32, torch.int32),
                                         (np.float64, torch.int64)])
def test_ordered_state_lane_by_dtype(monkeypatch, dtype, state):
    """The f32 ordered lane hands the tile solve int32 states (the int32
    kernel's instantiation on the card), the f64 lane int64 states, each
    seeded at ``iinfo.min`` outside the field."""
    seen = []
    real = pt_device.solve_tiles_blockwise

    def spy(sub_h, flags):
        seen.append((sub_h.dtype, int(sub_h.min())))
        return real(sub_h, flags)

    monkeypatch.setattr(pt_device, "solve_tiles_blockwise", spy)
    x = make_family("smooth", (12, 10, 8), dtype)
    pt_engine.compress(x, EB, adaptive_eb="tda", device="cpu")
    assert seen and all(dt == state for dt, _ in seen)
    assert seen[0][1] == torch.iinfo(state).min


def test_subnormal_field_compresses_as_the_reference():
    """A float32 field with subnormal cells: the reference compares them
    as zeros (XLA's denormals-are-zero), so the port's flags do too; the
    uniform and the adaptive containers equal the reference's."""
    x = make_family("denormal", (12, 10, 8), np.float32)
    assert (np.abs(x) < np.finfo(np.float32).tiny).any()
    assert pt_engine.compress(x, EB, device="cpu") == \
        ref_engine.compress(x, EB, solver="jacobi")
    _check_same(x, {"solver": "jacobi"})
