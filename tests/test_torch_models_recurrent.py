"""The port's recurrent architectures (zamba2: mamba2 with a shared
attention block; rwkv6) against the JAX reference on the CPU, with the
tolerances of ``test_torch_models.py`` (f32 compute), and their chunked
scans across more than one chunk, which the reduced models' prompts
never reach."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as ref_mamba2
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.models import mamba2, rwkv6
from test_torch_models import F32_RTOL, assert_close, check_step
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)

CASES = [("zamba2-1.2b", "float32", False), ("rwkv6-7b", "float32", False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_prefill_matches_reference(case):
    check_step(case, 0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_decode_matches_reference(case):
    for step in (1, 2):
        check_step(case, step)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_ssd_scan_over_two_chunks_matches_reference():
    """256 steps: two chunks of 128 and the state carried between them."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 2 * mamba2.CHUNK, 3, 8, 16
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bt = rng.standard_normal((b, s, n)).astype(np.float32)
    ct = rng.standard_normal((b, s, n)).astype(np.float32)
    dt_a = -rng.random((b, s, h)).astype(np.float32) * 0.1
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    y_ref, hf_ref = ref_mamba2._ssd_chunked(
        *(jnp.asarray(a) for a in (xh, bt, ct, dt_a)), None, jnp.asarray(h0))
    y, hf = mamba2._ssd_chunked(*_t(xh, bt, ct, dt_a, h0))
    assert_close(np.asarray(y_ref), y.numpy(), F32_RTOL, "y")
    assert_close(np.asarray(hf_ref), hf.numpy(), F32_RTOL, "state")


def test_wkv_scan_over_two_chunks_matches_reference():
    """128 steps: two chunks of 64 and the state carried between them."""
    rng = np.random.default_rng(4)
    b, s, h, hd = 2, 2 * rwkv6.CHUNK, 2, 8
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, hd)).astype(np.float32) - 3.0)
    u = rng.standard_normal((h, hd)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    y_ref, sf_ref = ref_rwkv6._chunked_wkv(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    y, sf = rwkv6._chunked_wkv(*_t(r, k, v, logw, u, s0))
    assert_close(np.asarray(y_ref), y.numpy(), F32_RTOL, "y")
    assert_close(np.asarray(sf_ref), sf.numpy(), F32_RTOL, "state")


def test_causal_conv_with_state_matches_reference():
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for st in (None, state):
        out_ref, new_ref = ref_mamba2._causal_conv(
            jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
            None if st is None else jnp.asarray(st))
        out, new = mamba2._causal_conv(
            *_t(xbc, w, bias), None if st is None else _t(st)[0])
        assert_close(np.asarray(out_ref), out.numpy(), F32_RTOL, "out")
        assert np.array_equal(np.asarray(new_ref), new.numpy())
