"""The port's halo-round solve (``engine.device.resident_solve``) against
the JAX reference's, on the CPU, on fields whose chains cross several
tiles.

From round 2 on the port gathers and solves only the tiles whose halo
reads a tile that moved in the round before; the reference solves every
tile every round.  The interiors, ``local1`` (round 1's per-tile sweep
count), ``last_round`` and the number of rounds must be the same, no
round may solve more tiles than round 1, and on the 4x4x4-tile ramp the
later rounds must solve fewer.  (On 2x2x2 tiles every tile borders every
other, and the staircase's tiles settle in round 1, so there a round
after the first re-solves every tile.)  The operands are the ones the
port's own compress hands the solve, captured on the way; the reference
runs its Pallas tile kernel in interpret mode on the same numpy arrays.
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.engine import device as ref_device
from repro_torch import engine as pt_engine
from repro_torch.engine import device as pt_device
from repro_torch.engine import halo as pt_halo

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_tda import staircase  # noqa: E402


def _ramp(tiles: int):
    """A field of ``tiles`` x ``tiles`` x ``tiles`` 4x4x8 tiles falling in
    linear index inside one bin: one chain through every tile, in every
    axis."""
    shape = (4 * tiles, 4 * tiles, 8 * tiles)
    return -np.arange(np.prod(shape), dtype=np.float64).reshape(shape) * 1e-9


_TILE_448 = {"plan": pt_engine.CompressionPlan(tile_shape=(4, 4, 8))}
CASES = {
    # (field, eb, compress keywords)
    "ramp-2x2x2-tiles": (lambda: _ramp(2), 1.0, _TILE_448),
    "ramp-4x4x4-tiles": (lambda: _ramp(4), 1.0, _TILE_448),
    "adaptive-staircase-f32": (lambda: staircase(np.float32), 1e-2,
                               {"adaptive_eb": "tda"}),
    "adaptive-staircase-f64": (lambda: staircase(np.float64), 1e-2,
                               {"adaptive_eb": "tda"}),
}


def _captured_solves(monkeypatch, case):
    make, eb, kw = CASES[case]
    calls = []
    real = pt_device.resident_solve

    def spy(flags, idx, mask, max_rounds, adjacency, sub0=None, n_real=None):
        out = real(flags, idx, mask, max_rounds, adjacency=adjacency,
                   sub0=sub0, n_real=n_real)
        calls.append(((flags, idx, mask, max_rounds, sub0, n_real), out,
                      pt_device.SOLVED_TILES[-1]))
        return out

    monkeypatch.setattr(pt_device, "resident_solve", spy)
    pt_engine.compress(make(), eb, device="cpu", **kw)
    assert calls
    return calls


def _biased(s: np.ndarray) -> np.ndarray:
    """The signed ordered state as the reference's biased unsigned one."""
    udt = np.uint32 if s.dtype == np.int32 else np.uint64
    return s.view(udt) ^ (udt(1) << udt(8 * s.itemsize - 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_active_tile_rounds_match_reference(monkeypatch, case):
    for (flags, idx, mask, max_rounds, sub0, n_real), out, solved in (
            _captured_solves(monkeypatch, case)):
        cur, local1, last_round, rounds = out
        tile_elems = int(np.prod(flags.shape[1:]))
        want, want_local1, want_last = ref_device.resident_solve(
            jnp.asarray(flags.numpy().view(np.uint32)), jnp.asarray(idx.numpy()),
            jnp.asarray(mask.numpy()), max_rounds, solver="blockwise",
            interpret=True, local_max_iters=tile_elems + 2,
            sub0=None if sub0 is None else jnp.asarray(_biased(sub0.numpy())))
        want = np.asarray(want)
        got = cur.numpy() if sub0 is None else _biased(cur.numpy())
        assert np.array_equal(got, want)
        assert np.array_equal(local1.numpy(), np.asarray(want_local1))
        assert np.array_equal(last_round.numpy(), np.asarray(want_last))
        # the reference's loop runs until a round moves nothing
        assert rounds == min(int(np.asarray(want_last).max()) + 1, max_rounds)
        # round 1 solves every real tile, no later round more
        assert solved[0] == n_real and len(solved) <= rounds
        assert max(solved[1:], default=0) <= solved[0]
        if case.startswith("ramp"):
            assert rounds >= 4  # the chain crosses tiles
        if case == "ramp-4x4x4-tiles":
            # tiles whose neighbours all settled are no longer solved
            assert solved[-1] < solved[0] and sum(solved) < rounds * solved[0]


@pytest.mark.parametrize("shapes", [
    [(16, 16, 32)],                       # 4x4x4 tiles of 4x4x8
    [(8, 12, 40), (4, 4, 8), (20, 8, 8)],  # a group of three fields
])
def test_group_adjacency_is_read_off_the_halo_table(shapes):
    """The tile pairs the active-tile rounds use are exactly those whose
    halo cells the group's gather table fills from another tile."""
    plan = _TILE_448["plan"]
    layouts = tuple(plan.layout_for(s) for s in shapes)
    n_real = sum(lay.n_tiles for lay in layouts)
    idx, mask = pt_halo.group_index(layouts, n_real + 3)
    elems = int(np.prod(layouts[0].tile))
    src = idx.reshape(idx.shape[0], -1).astype(np.int64) // elems
    dst = np.broadcast_to(np.arange(idx.shape[0])[:, None], src.shape)
    keep = mask.reshape(mask.shape[0], -1) & (src != dst)
    want = set(zip(dst[keep].tolist(), src[keep].tolist()))
    got_dst, got_src = pt_halo.group_adjacency(layouts)
    got = list(zip(got_dst.tolist(), got_src.tolist()))
    assert len(got) == len(set(got)) and set(got) == want
    assert max(max(p) for p in got) < n_real  # pad tiles take no part
