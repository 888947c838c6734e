"""The port's LM training path (``repro_torch.optim``,
``repro_torch.data.pipeline``, ``repro_torch.runtime.steps``) against
the JAX reference on the CPU; the loss and gradients of every
architecture are in ``test_torch_train_grads.py``.

Tolerances (the measured maxima are in the comments beside them):

- schedules: the WSD rate within 1 f32 ulp of the reference's; the
  cosine rate within 1 f32 ulp of ``base_lr``: the reference's f32
  cosine (XLA's) and the port's (correctly rounded) differ in the last
  bit of ``cos``, which ``1 + cos`` near -1 magnifies in ulps of the
  rate, not in ulps of ``base_lr * 0.5``;
- AdamW, fed the reference's own grads, moments, step and clip scale:
  parameters and moments within 2 ulp; the global gradient norm within
  1e-5 relative (the two packages sum the squares in other orders);
  a whole ``adamw_update`` within ``rtol=2e-6`` plus ``2e-6 * lr``
  absolute for the parameters and ``1e-5 * max|ref leaf|`` absolute for
  the moments (the clip scale's last bits, carried into moments that
  cancel to near zero);
- one whole ``make_train_step`` in f32 compute: loss and grad norm
  within 1e-5 relative, the parameters within ``rtol=1e-5`` plus ``0.05
  * lr``;
- the synthetic stream: bit-equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMStream as RefStream
from repro.models import model as ref_model
from repro.models.config import reduced_for_smoke as ref_reduced
from repro.models.inputs import dummy_batch as ref_dummy_batch
from repro.models.registry import get_arch as ref_get_arch
from repro.optim import adamw as ref_adamw
from repro.optim.schedules import cosine_schedule as ref_cosine
from repro.optim.schedules import wsd_schedule as ref_wsd
from repro.runtime import steps as ref_steps
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.models import get_arch, reduced_for_smoke
from repro_torch.models.convert import (
    opt_from_reference,
    opt_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.inputs import dummy_batch
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule
from repro_torch.runtime import steps
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)

B, S = 2, 32


def ulps(a, b) -> int:
    """The largest distance between ``a`` and ``b`` in f32 ulps."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int(np.abs(ia - ib).max()) if ia.size else 0


# ------------------------------------------------------------- schedules

SCHEDULES = [(3e-4, 10, 100), (1e-3, 200, 2000), (1e-3, 2, 30)]


@pytest.mark.parametrize("base, warmup, total", SCHEDULES)
def test_schedules_match_the_reference(base, warmup, total):
    ref_c, mine_c = ref_cosine(base, warmup, total), cosine_schedule(base, warmup, total)
    ref_w, mine_w = ref_wsd(base, warmup, total), wsd_schedule(base, warmup, total)
    unit = float(np.spacing(np.float32(base)))
    for step in range(total + 1):
        rc, mc = np.float32(ref_c(step)), mine_c(step)
        assert mc.dtype == torch.float32 and mc.dim() == 0
        # measured: at most 1.0 ulp of base_lr
        assert abs(float(rc) - float(mc)) <= unit, step
        if step <= warmup:
            assert float(rc) == float(mc), step
        # measured: 0 ulps
        assert ulps(np.float32(ref_w(step)), mine_w(step).numpy()) <= 1, step


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2.5-3b"])
def test_lr_schedule_kind(arch):
    ref = ref_steps.make_lr_schedule(ref_get_arch(arch).config, 1e-3, total=50)
    mine = steps.make_lr_schedule(get_arch(arch).config, 1e-3, total=50)
    for step in (0, 3, 5, 20, 46, 48, 50):  # warmup, plateau/cosine, tail
        assert abs(float(np.float32(ref(step))) - float(mine(step))) \
            <= float(np.spacing(np.float32(1e-3))), step


# ------------------------------------------------------------------ AdamW

# zamba2 cut to one group of its 6-block pattern plus a 2-block tail:
# the shared block, the tail and the group's stacked leaves all present
ADAMW_CASES = {"zamba2-tail-shared": ("zamba2-1.2b", 8),
               "qwen2.5-3b": ("qwen2.5-3b", None)}


def _cfgs(arch, n_layers=None, **kw):
    ref = ref_reduced(ref_get_arch(arch).config)
    mine = reduced_for_smoke(get_arch(arch).config)
    if n_layers is not None:
        kw["n_layers"] = n_layers
    return ref.scaled(**kw), mine.scaled(**kw)


def reference_ranks(params, cfg) -> dict:
    """``{port parameter name: the leaf's rank in the reference's tree}``
    (a grouped leaf's rank counts its stacked group axis)."""
    ranks = {k: jax.tree.map(
        (lambda x: np.full(np.shape(x)[:1], np.ndim(x))) if k == "groups"
        else (lambda x: np.asarray(np.ndim(x))), v) for k, v in params.items()}
    return {k: int(v) for k, v in params_from_reference(ranks, cfg).items()}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_decay_follows_the_reference_stacked_rank(case):
    arch, n_layers = ADAMW_CASES[case]
    rcfg, cfg = _cfgs(arch, n_layers)
    rank = reference_ranks(jax.eval_shape(
        lambda k: ref_model.init_params(rcfg, k), jax.random.PRNGKey(0)), cfg)
    names = dict(Model(cfg, device="cpu").named_parameters())
    mask = adamw.decay_mask(names, cfg)
    assert set(rank) == set(names)
    for name, p in names.items():
        # the reference decays a leaf iff its own (stacked) rank is >= 2
        assert p.dim() + int(mask[name]) == rank[name], name
    if case.startswith("zamba2"):
        # 1-D leaves: the group's decay, the shared block's, the tail's
        # and the final norm's do not
        assert mask["layers.0.mamba.norm.scale"]
        assert not mask["shared.attn.norm.scale"]
        assert not mask["layers.6.mamba.norm.scale"]
        assert not mask["final_norm.scale"]
        assert rank["layers.0.mamba.norm.scale"] == 2
        assert rank["layers.7.mamba.d_skip"] == 1


def _adamw_runs(case, steps_n=2):
    """The reference's AdamW over ``steps_n`` steps of its own grads, and
    at each step the port fed the reference's inputs."""
    arch, n_layers = ADAMW_CASES[case]
    rcfg, cfg = _cfgs(arch, n_layers)
    params = jax.jit(lambda k: ref_model.init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    state = ref_adamw.adamw_init(params)
    sched = ref_steps.make_lr_schedule(rcfg, 1e-3, total=20)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.train_loss(p, b, rcfg), has_aux=True))
    upd = jax.jit(lambda g, s, p: ref_adamw.adamw_update(g, s, p, sched))
    out = []
    for it in range(steps_n):
        _, grads = vg(params, ref_dummy_batch(rcfg, B, S, seed=it))
        inputs = jax.tree.map(np.asarray, (grads, state, params))
        params, state, met = upd(grads, state, params)
        out.append((inputs, jax.tree.map(np.asarray, (params, state, met))))
    return cfg, out


def _port_inputs(inputs, cfg):
    grads, state, params = inputs
    return (params_from_reference(grads, cfg), opt_from_reference(state, cfg),
            params_from_reference(params, cfg))


def _used(got, want, rtol: float, atol: float) -> float:
    """The largest share of ``atol + rtol * |want|`` that ``|got - want|``
    uses (<= 1 passes)."""
    d = np.abs(got.astype(np.float64) - want)
    return float((d / (atol + rtol * np.abs(want))).max())


def adamw_errors(case) -> dict:
    """Per step: ulps of the update at the reference's clip scale and
    rate, the global norm's relative error, and the share of its
    tolerance the whole update uses (parameters, moments)."""
    cfg, runs = _adamw_runs(case)
    psched = steps.make_lr_schedule(cfg, 1e-3, total=20)
    out = []
    for it, (inputs, (rparams, rstate, met)) in enumerate(runs):
        want_p = {k: v.numpy() for k, v in params_from_reference(rparams, cfg).items()}
        want_o = opt_from_reference(rstate, cfg)
        want_m = {k: {n: t.numpy() for n, t in want_o[k].items()} for k in ("m", "v")}
        # the update alone, at the reference's clip scale and rate
        grads, state, params = _port_inputs(inputs, cfg)
        decay = adamw.decay_mask(params, cfg)
        scale = adamw.clip_scale(torch.tensor(met["grad_norm"]))
        adamw.apply_update(grads, state, params, scale,
                           torch.tensor(met["lr"]), decay=decay)
        assert int(state["step"]) == int(rstate["step"]) == it + 1
        res = {"ulps": max(max(ulps(want_p[n], params[n].numpy()),
                               *(ulps(want_m[k][n], state[k][n].numpy())
                                 for k in ("m", "v"))) for n in params)}
        # the whole update: the port's own norm, scale and rate
        grads, state, params = _port_inputs(inputs, cfg)
        _, state, pm = adamw.adamw_update(grads, state, params, psched,
                                          decay=decay)
        assert float(pm["lr"]) == float(met["lr"])
        res["grad_norm"] = abs(float(pm["grad_norm"]) - float(met["grad_norm"])) \
            / float(met["grad_norm"])
        lr = float(met["lr"])
        res["params"] = max(_used(params[n].numpy(), want_p[n], 2e-6, 2e-6 * lr)
                            for n in params)
        res["moments"] = max(
            _used(state[k][n].numpy(), want_m[k][n], 2e-6,
                  1e-5 * float(np.abs(want_m[k][n]).max()))
            for k in ("m", "v") for n in params)
        out.append(res)
    return out


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_matches_the_reference(case):
    for res in adamw_errors(case):
        # measured: 0 ulps; norm 5.8e-7; 19% of the parameters' and 12%
        # of the moments' tolerance
        assert res["ulps"] <= 2
        assert res["grad_norm"] <= 1e-5
        assert res["params"] <= 1 and res["moments"] <= 1


# ------------------------------------------------------------- the stream

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llava-next-mistral-7b",
                                  "hubert-xlarge"])
def test_stream_batches_are_bit_equal(arch):
    rcfg, cfg = _cfgs(arch)
    for kw in ({}, {"seed": 3, "shard": 1, "n_shards": 2}):
        ref = RefStream(rcfg, 4, 24, **kw)
        mine = SyntheticLMStream(cfg, 4, 24, **kw)
        for step in (0, 1, 7, 1000):
            a, b = ref.batch_at(step), mine.batch_at(step)
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), (k, step)


# ----------------------------------------------- one whole training step

def step_errors(arch) -> list:
    """The reference's ``make_train_step`` from its ``init_train_state``
    and the port's on the same state carried across by ``convert``, in
    f32 compute, 2 steps: per step the metrics' relative errors and the
    share of its tolerance the parameters use."""
    rcfg, cfg = _cfgs(arch, dtype="float32")
    rparams, ropt = ref_steps.init_train_state(rcfg, jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, rparams),
                                                cfg))
    opt = opt_from_reference(jax.tree.map(np.asarray, ropt), cfg)
    # the conversion is its own inverse
    back = params_to_reference(model.state_dict(), cfg)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(rparams),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb and np.array_equal(np.asarray(a), b.numpy())
    assert jax.tree.structure(jax.tree.map(np.asarray, ropt)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(),
                                        opt_to_reference(opt, cfg)))
    stream = SyntheticLMStream(cfg, 2, 16)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, base_lr=1e-3, total_steps=20))
    step = steps.make_train_step(cfg, base_lr=1e-3, total_steps=20)
    out = []
    for it in range(2):
        batch = stream.batch_at(it)
        rparams, ropt, rmet = rstep(rparams, ropt, batch)
        model, opt, met = step(model, opt, batch)
        assert set(met) == set(rmet)
        assert int(opt["step"]) == int(ropt["step"]) == it + 1
        res = {k: abs(float(met[k]) - float(rmet[k]))
               / max(1.0, abs(float(rmet[k]))) for k in rmet}
        want = params_from_reference(jax.tree.map(np.asarray, rparams), cfg)
        lr = float(rmet["lr"])
        res["params"] = max(_used(p.detach().numpy(), want[n].numpy(), 1e-5,
                                  0.05 * lr)
                            for n, p in model.named_parameters())
        out.append(res)
    return out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b"])
def test_train_step_from_init_train_state(arch):
    for res in step_errors(arch):
        # measured: loss 2.0e-7 relative, grad norm 1.7e-7; 22% of the
        # parameters' tolerance
        for k, v in res.items():
            if k != "params":
                assert v <= 1e-5, k
        # step 1 moves every weight by about lr * sign(g): a gradient of a
        # few 1e-8 (the update's eps) may round its move apart
        assert res["params"] <= 1


def test_step_wrappers_match_the_reference():
    """``make_encoder_forward`` (hubert, f32 compute) within 1e-4 of the
    reference's largest value; ``make_prefill`` and ``make_decode_step``
    are the model's own calls."""
    rcfg, cfg = _cfgs("hubert-xlarge", dtype="float32")
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    want = np.asarray(jax.jit(ref_steps.make_encoder_forward(rcfg))(
        params, ref_dummy_batch(rcfg, B, 8)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params),
                                                cfg))
    got = steps.make_encoder_forward(cfg)(model, dummy_batch(cfg, B, 8))
    assert got.shape == want.shape and not got.requires_grad
    # measured: 4.3e-7
    assert float(np.abs(got.numpy() - want).max()) <= \
        1e-4 * float(np.abs(want).max())
    _, cfg = _cfgs("qwen2.5-3b")
    model = Model(cfg, device="cpu")
    batch = dummy_batch(cfg, B, 8)
    logits, caches = steps.make_prefill(cfg, 10)(model, batch)
    assert torch.equal(logits, model.prefill(batch, 10)[0])
    nxt, _ = steps.make_decode_step(cfg)(model, logits.argmax(-1), caches)
    assert nxt.shape == logits.shape and caches["len"] == 9


# ------------------------------------------------ serving stays as it was

@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_serving_forward_reads_the_cached_copy_and_records_no_graph(mode):
    """The weights are trainable now; a serving forward still casts each
    one to the compute dtype once and builds no autograd graph, while a
    forward with grad enabled casts inside the graph."""
    from repro_torch.models.common import cast_weight

    _, cfg = _cfgs("qwen2.5-3b")
    model = Model(cfg, device="cpu")
    attn = model.layers[0].attn
    assert attn.wq.requires_grad and attn.norm.scale.requires_grad
    ctx = getattr(torch, mode)
    with ctx():
        logits, caches = model.prefill(dummy_batch(cfg, 2, 8), 10)
        copy = cast_weight(attn, "wq", torch.bfloat16)
        assert cast_weight(attn, "wq", torch.bfloat16) is copy
        logits2, _ = model.decode_step(logits.argmax(-1), caches)
    for t in (logits, logits2, copy, caches["layers"][0]["attn"]["k"]):
        assert not t.requires_grad and t.grad_fn is None
    assert attn.__dict__["_cast"][("wq", torch.bfloat16)][1] is copy
    # with grad: a fresh cast in the graph, the cache untouched
    live = cast_weight(attn, "wq", torch.bfloat16)
    assert live.grad_fn is not None and live is not copy
    assert attn.__dict__["_cast"][("wq", torch.bfloat16)][1] is copy


if __name__ == "__main__":
    # the measured maxima:  PYTHONPATH=src python tests/test_torch_train.py
    torch.set_num_threads(1)
    for base, warmup, total in SCHEDULES:
        rc, mc = ref_cosine(base, warmup, total), cosine_schedule(base, warmup, total)
        rw, mw = ref_wsd(base, warmup, total), wsd_schedule(base, warmup, total)
        unit = float(np.spacing(np.float32(base)))
        print(f"schedules {base} {warmup} {total}: cosine "
              f"{max(abs(float(np.float32(rc(s))) - float(mc(s))) for s in range(total + 1)) / unit}"
              f" ulp of base_lr, wsd "
              f"{max(ulps(np.float32(rw(s)), mw(s).numpy()) for s in range(total + 1))} ulps",
              flush=True)
    for case in ADAMW_CASES:
        print("adamw", case, adamw_errors(case), flush=True)
    for arch in ("qwen2.5-3b", "dbrx-132b"):
        print("train step", arch, step_errors(arch), flush=True)
