"""The port's LM serving path (``repro_torch.models``, ``serve --arch``)
against the JAX reference on the CPU.

Each architecture's reduced config runs once per module: the reference
through ``jax.jit`` of its own ``prefill`` and ``decode_step`` (prefill
plus 2 decode steps), the port on the same parameters
(``convert.params_from_reference``) and the same batch; the decode
steps take the reference's greedy tokens.  Tolerances, with ``R =
max(1, max|ref|)`` per array:

- f32 compute: logits and float caches within ``1e-4 * R``, equal
  greedy tokens.  A cache leaf the reference stores in bf16 may also
  differ by one bf16 step in at most 0.1% of its entries: the f32 value
  before the store differs by an f32 rounding (the matmuls' summation
  order), which moves a value lying at a bf16 rounding midpoint.
- bf16 compute (qwen2.5-3b and gemma2): logits and caches within
  ``3e-2 * R``.
- int8 KV cache (qwen2.5-3b, f32 compute): codes differ by at most 1 in
  at most 0.1% of entries, scales within ``1e-4 * R``, logits within
  ``1e-2 * R``.

zamba2 and rwkv6 are in ``test_torch_models_recurrent.py``.
"""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as ref_engine
from repro.models import model as ref_model
from repro.models.attention import blockwise_attention as ref_attention
from repro.models.config import reduced_for_smoke as ref_reduced
from repro.models.inputs import dummy_batch as ref_dummy_batch
from repro.models.registry import ARCHITECTURES as REF_ARCHITECTURES
from repro.models.registry import get_arch as ref_get_arch
from repro_torch import engine as pt_engine
from repro_torch.configs import lopc as pt_lopc
from repro_torch.models import ARCHITECTURES, get_arch, reduced_for_smoke
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.convert import cache_to_reference, params_from_reference
from repro_torch.models.inputs import dummy_batch
from repro_torch.models.model import Model
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
B, S, GEN = 2, 20, 2
F32_RTOL, BF16_RTOL, INT8_LOGIT_RTOL = 1e-4, 3e-2, 1e-2
FLIP_SHARE = 1e-3  # bf16 steps and int8 code steps: at most 0.1% of entries

# (arch, compute dtype, int8 KV); zamba2 and rwkv6 run in the sibling file
CASES = [(a, "float32", False) for a in (
    "qwen2.5-3b", "starcoder2-15b", "minicpm-2b", "gemma2-27b",
    "llava-next-mistral-7b", "dbrx-132b", "mixtral-8x22b")] + [
    ("qwen2.5-3b", "bfloat16", False), ("gemma2-27b", "bfloat16", False),
    ("qwen2.5-3b", "float32", True)]
# hubert is encoder-only: its prefill (the frames input, bidirectional
# attention, the untied head) and no decode step
PREFILL_ONLY = [("hubert-xlarge", "float32", False)]


def case_id(case) -> str:
    arch, dtype, kvq = case
    return f"{arch}-{'int8kv' if kvq else dtype}"


# ------------------------------------------------------------------ runs

def _ref_np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def reference_run(arch: str, dtype: str, kv_quant: bool) -> dict:
    """The reference's prefill and GEN greedy decode steps: per step the
    logits, the cache tree (numpy; bf16 leaves as float32) and the token
    fed to the next step."""
    cfg = ref_reduced(ref_get_arch(arch).config).scaled(dtype=dtype,
                                                        kv_quant=kv_quant)
    params = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    batch = ref_dummy_batch(cfg, B, S)
    logits, caches = jax.jit(
        lambda p, b: ref_model.prefill(p, b, cfg, S + GEN))(params, batch)
    dec = jax.jit(lambda p, t, c: ref_model.decode_step(p, t, c, cfg))
    run = {"params": jax.tree.map(np.asarray, params),
           "cache_dtypes": jax.tree.map(lambda x: str(x.dtype), caches),
           "logits": [np.asarray(logits)],
           "caches": [jax.tree.map(_ref_np, caches)],
           "tokens": [np.asarray(jnp.argmax(logits, -1))]}
    for _ in range(0 if cfg.encoder_only else GEN):
        logits, caches = dec(params, jnp.asarray(run["tokens"][-1], jnp.int32),
                             caches)
        run["logits"].append(np.asarray(logits))
        run["caches"].append(jax.tree.map(_ref_np, caches))
        run["tokens"].append(np.asarray(jnp.argmax(logits, -1)))
    return run


def port_run(arch: str, dtype: str, kv_quant: bool, ref: dict) -> dict:
    """The port on the reference's parameters and tokens."""
    cfg = reduced_for_smoke(get_arch(arch).config).scaled(dtype=dtype,
                                                          kv_quant=kv_quant)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(ref["params"], cfg))
    logits, caches = model.prefill(dummy_batch(cfg, B, S), S + GEN)
    run = {"cfg": cfg, "logits": [logits.numpy()],
           "caches": [cache_to_reference(caches, cfg)]}
    for t in range(len(ref["logits"]) - 1):
        logits, caches = model.decode_step(torch.from_numpy(ref["tokens"][t]),
                                           caches)
        run["logits"].append(logits.numpy())
        run["caches"].append(cache_to_reference(caches, cfg))
    return run


_RUNS: dict = {}


def runs(case) -> tuple[dict, dict]:
    """(reference, port) of a case, computed once per module."""
    if case not in _RUNS:
        ref = reference_run(*case)
        _RUNS[case] = (ref, port_run(*case, ref))
    return _RUNS[case]


# ------------------------------------------------------------ tolerances

def _bound(ref, rtol) -> float:
    return rtol * max(1.0, float(np.abs(ref).max()))


def assert_close(ref, got, rtol, what: str) -> float:
    err = float(np.abs(np.asarray(ref, np.float64) - got).max())
    assert err <= _bound(ref, rtol), f"{what}: max|d| {err:.3e}"
    return err


def assert_bf16_leaf(ref, got, rtol, what: str) -> None:
    """Within ``rtol * R``, or one bf16 step off in at most 0.1% of the
    entries."""
    d = np.abs(np.asarray(ref, np.float64) - got)
    off = d > _bound(ref, rtol)
    step = np.maximum(np.spacing(np.abs(ref).astype(np.float32)),
                      np.spacing(np.abs(got).astype(np.float32))) * 2.0**16
    assert (d[off] <= step[off]).all(), f"{what}: more than one bf16 step"
    assert off.mean() <= FLIP_SHARE, f"{what}: {int(off.sum())} bf16 steps"


def assert_int8_leaf(ref, got, what: str) -> None:
    d = np.abs(ref.astype(np.int32) - got.astype(np.int32))
    assert d.max() <= 1, f"{what}: codes differ by {d.max()}"
    assert (d > 0).mean() <= FLIP_SHARE, f"{what}: {int((d > 0).sum())} codes"


def assert_caches(ref_tree, got_tree, dtypes, rtol) -> None:
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    kinds = dict(jax.tree_util.tree_leaves_with_path(dtypes))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert len(ref_leaves) == len(got)
    for path, ref in ref_leaves:
        what = jax.tree_util.keystr(path)
        assert path in got, what
        mine = got[path]
        assert np.shape(mine) == np.shape(ref), what
        if kinds[path] == "int8":
            assert_int8_leaf(ref, mine, what)
        elif kinds[path] == "bfloat16" and rtol == F32_RTOL:
            assert_bf16_leaf(ref, mine, rtol, what)
        else:
            assert_close(ref, mine, rtol, what)


def check_step(case, step: int) -> None:
    arch, dtype, kvq = case
    ref, mine = runs(case)
    rtol = BF16_RTOL if dtype == "bfloat16" else F32_RTOL
    lr, lm = ref["logits"][step], mine["logits"][step]
    assert lm.shape == lr.shape == (B, mine["cfg"].vocab)
    assert np.isfinite(lm).all()
    assert_close(lr, lm, INT8_LOGIT_RTOL if kvq else rtol, f"step {step} logits")
    if dtype == "float32":
        assert np.array_equal(lm.argmax(-1), ref["tokens"][step])
    assert_caches(ref["caches"][step], mine["caches"][step],
                  ref["cache_dtypes"], rtol)
    assert mine["caches"][step]["len"] == S + step


@pytest.mark.parametrize("case", CASES + PREFILL_ONLY, ids=case_id)
def test_prefill_matches_reference(case):
    check_step(case, 0)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_decode_matches_reference(case):
    for step in range(1, GEN + 1):
        check_step(case, step)


# --------------------------------------------------- configs and batches

@pytest.mark.parametrize("arch", REF_ARCHITECTURES)
def test_config_and_spec_equal_the_reference(arch):
    ref, mine = ref_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(mine.config) == dataclasses.asdict(ref.config)
    assert dataclasses.asdict(reduced_for_smoke(mine.config)) == \
        dataclasses.asdict(ref_reduced(ref.config))
    assert mine.skip_shapes == ref.skip_shapes  # the CLI's refusal texts
    assert mine.shape_overrides == ref.shape_overrides
    assert ARCHITECTURES == REF_ARCHITECTURES


def test_lopc_config_equals_the_reference():
    from repro.configs import lopc as ref_lopc

    assert dataclasses.asdict(pt_lopc.CONFIG) == dataclasses.asdict(ref_lopc.CONFIG)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llava-next-mistral-7b",
                                  "hubert-xlarge"])
def test_dummy_batch_equals_the_reference(arch):
    cfg = reduced_for_smoke(get_arch(arch).config)
    ref = ref_dummy_batch(ref_reduced(ref_get_arch(arch).config), 3, 12, seed=4)
    mine = dummy_batch(cfg, 3, 12, seed=4)
    assert list(mine) == list(ref)
    for k, r in ref.items():
        assert str(mine[k].dtype).removeprefix("torch.") == str(r.dtype), k
        assert np.array_equal(mine[k].float().numpy(),
                              np.asarray(r.astype(jnp.float32))), k


# -------------------------------------------------- attention on its own

def _attn_inputs(seed, b, hq, hkv, sq, skv, d, int8=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (b, hkv, skv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, hkv, skv, d)).astype(np.int8)
        ks = (rng.random((b, hkv, skv, 1)) * 0.02).astype(np.float32)
        vs = (rng.random((b, hkv, skv, 1)) * 0.02).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    return q, k, v, None, None


ATTN_CASES = {
    # name: (shapes (b, hq, hkv, sq, skv, d), keyword arguments)
    "causal": ((2, 4, 2, 24, 24, 16), {}),
    "window": ((2, 4, 2, 24, 24, 16), {"window": 8}),
    "kv_len": ((2, 4, 2, 1, 32, 16), {"q_offset": 10, "kv_len": 11}),
    "negative_k_start": ((2, 4, 2, 1, 8, 16),
                         {"q_offset": 5, "k_start": -2, "window": 8}),
    "softcap": ((2, 4, 2, 24, 24, 16), {"cap": 2.0}),
    "int8_scales": ((2, 4, 2, 1, 32, 16), {"q_offset": 20, "kv_len": 21}),
    "non_causal": ((2, 4, 4, 12, 12, 16), {"causal": False}),
    # 2 blocks of 1024: the only way to reach the recurrence across blocks
    "two_blocks_2048": ((1, 2, 1, 4, 2048, 16), {"q_offset": 2044}),
}


@pytest.mark.parametrize("name, kv_dtype", [
    (n, dt) for n in ATTN_CASES
    for dt in (("int8",) if n == "int8_scales" else ("bfloat16", "float32"))])
def test_blockwise_attention_matches_reference(name, kv_dtype):
    """f32 queries over bf16 KV (the f32-compute serving form: the cache
    is bf16), f32 KV, and int8 KV with its scales."""
    (b, hq, hkv, sq, skv, d), kw = ATTN_CASES[name]
    int8 = kv_dtype == "int8"
    q, k, v, ks, vs = _attn_inputs(len(name), b, hq, hkv, sq, skv, d, int8)
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float32": (jnp.float32, torch.float32),
                "int8": (None, None)}[kv_dtype]
    scales = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    ref = ref_attention(
        jnp.asarray(q), *(jnp.asarray(t) if int8 else jnp.asarray(t, jdt)
                          for t in (k, v)),
        **kw, **{n: jnp.asarray(s) for n, s in scales.items()})
    got = blockwise_attention(
        torch.from_numpy(q), *(torch.from_numpy(t) if int8
                               else torch.from_numpy(t).to(tdt) for t in (k, v)),
        **kw, **{n: torch.from_numpy(s) for n, s in scales.items()})
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq, d)
    assert_close(np.asarray(ref), got.numpy(), F32_RTOL, name)


# ----------------------------------------------- LOPC on the KV state

def _kv_blocks():
    """The reduced qwen's prefill K and V (f32 compute, bf16 cache), per
    layer, as (B, Hkv*S*D) float32 blocks."""
    _, mine = runs(CASES[0])
    slot = mine["caches"][0]["groups"]["slot0"]["attn"]
    return {f"{kind}{g}": slot[kind][g].reshape(B, -1)
            for kind in ("k", "v") for g in range(slot[kind].shape[0])}


@pytest.mark.parametrize("block", ["k0", "v1"])
def test_kv_block_containers_equal_the_reference(block):
    x = _kv_blocks()[block]
    mine = pt_engine.compress(x, 1e-3, mode="abs", device="cpu")
    assert mine == ref_engine.compress(x, 1e-3, mode="abs")
    y = pt_engine.decompress(mine, device="cpu")
    assert float(np.abs(y - x).max()) <= 1e-3


# ------------------------------------------------------------------ CLI

def _serve(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_serve_arch_prints_the_report_line():
    out = _serve("--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "16", "--gen", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(r"^qwen2\.5-3b: prefill 2x16 in [0-9.]+s; decoded 8 "
                     r"tokens in [0-9.]+s \([0-9.]+ tok/s\)$", out.stdout, re.M)
    assert re.search(r"^sample: \[(\d+, ){4}\d+\]$", out.stdout, re.M)


def test_serve_arch_refuses_an_encoder_only_model():
    out = _serve("--arch", "hubert-xlarge", "--device", "cpu")
    reason = ref_get_arch("hubert-xlarge").skip_shapes["decode_32k"]
    assert out.returncode != 0 and "Traceback" not in out.stderr
    assert f"hubert-xlarge has no decode step ({reason})" in out.stderr


def test_serve_arch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = _serve("--arch", "qwen2.5-3b", "--reduced", "--gen", "1")
    assert out.returncode != 0 and "device='cpu'" in out.stderr


def maxima(case) -> str:
    """One case's largest differences from the reference, over the
    prefill and the decode steps: logits / R, float cache leaves / R (a
    bf16 leaf's whole-step differences apart), the bf16 steps and the
    int8 codes that differ."""
    ref, mine = runs(case)
    logits = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(a).max()))
                 for a, b in zip(ref["logits"], mine["logits"]))
    kinds = dict(jax.tree_util.tree_leaves_with_path(ref["cache_dtypes"]))
    cache, steps, codes = 0.0, 0, 0
    for rc, mc in zip(ref["caches"], mine["caches"]):
        got = dict(jax.tree_util.tree_leaves_with_path(mc))
        for path, a in jax.tree_util.tree_leaves_with_path(rc):
            d = np.abs(np.asarray(a, np.float64) - got[path])
            if kinds[path] == "int8":
                codes = max(codes, int((d > 0).sum()))
                continue
            r = max(1.0, float(np.abs(a).max()))
            off = (d > _bound(a, F32_RTOL)) if (
                kinds[path] == "bfloat16" and case[1] == "float32") else d < 0
            steps = max(steps, int(off.sum()))
            cache = max(cache, float(d[~off].max(initial=0)) / r)
    return (f"{case_id(case)}: logits {logits:.2e} R, caches {cache:.2e} R, "
            f"bf16 steps {steps}, int8 codes {codes}")


if __name__ == "__main__":
    # the measured maxima:  PYTHONPATH=src python tests/test_torch_models.py
    from test_torch_models_recurrent import CASES as RECURRENT

    torch.set_num_threads(1)
    for c in CASES + PREFILL_ONLY + RECURRENT:
        print(maxima(c), flush=True)
