"""The port's LM on DTensors (``launch.shardings``, ``models.parallel``,
the MoE's EP and XP regions, AdamW on sharded leaves) against the
reference's sharded runs on the CPU.

The port runs on 4 gloo ranks (one subprocess each, a ``FileStore`` in
the test's temporary directory, one torch thread a rank); the reference
runs in one subprocess on 4 host devices
(``--xla_force_host_platform_device_count=4``) under its own sharding
rules, on meshes made with ``AxisType.Auto`` axes (``jax.make_mesh``'s
default explicit axes make this JAX version refuse the embedding
gather).  Both start at once from the same inputs: weights the port
draws (``Model``, ``MoE``) and hands over through ``convert.py``, and
batches drawn from numpy seeds.

Cases, each within its tolerance (``R``: the largest magnitude of the
reference's value or leaf):

- the MoE block, EP mode: reduced dbrx with 4 experts on mesh (data 2,
  model 2); XP mode: reduced mixtral with 2 experts on (data 1, model 4)
  (2 % 4 != 0, d_ff 128 divides by 4).  Outputs within 1e-5 R, aux
  within 1e-6 relative;
- reduced qwen2.5-3b, dbrx-132b and mixtral-8x22b on (2, 2):
  ``train_loss`` and every gradient leaf against ``jax.value_and_grad``,
  in f32 (loss within 1e-6 relative, gradients within 4e-5 R) and in
  bf16 (3.05e-2);
- one AdamW step of qwen2.5-3b (f32): the moments within 4e-5 R and the
  parameters within 4e-5 R;
- prefill and two decode steps with sharded caches, in f32: logits
  within 5.1e-7 R with the K/V stores in f32, within 1e-4 R as served
  (bf16 stores; ``test_torch_models.py``'s bound);
- an elastic restore: parameters saved from (2, 2) and restored onto
  (4, 1), bit-equal.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import get_arch, reduced_for_smoke
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.models.model import Model
from repro_torch.models.moe import MoE

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCHS = ("qwen2.5-3b", "dbrx-132b", "mixtral-8x22b")
DTYPES = ("float32", "bfloat16")
B, S, MAX_LEN, N_DECODE = 4, 32, 40, 2
TIMEOUT_S = 400
F32_GRAD, F32_LOSS, BF16 = 4e-5, 1e-6, 3.05e-2
MOE_OUT, MOE_AUX, SERVE, SERVED = 1e-5, 1e-6, 5.1e-7, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_cfg(mode: str):
    if mode == "ep":
        return reduced_for_smoke(get_arch("dbrx-132b").config).scaled(
            dtype="float32")
    return reduced_for_smoke(get_arch("mixtral-8x22b").config).scaled(
        dtype="float32", moe=MoEConfig(n_experts=2, top_k=2))


MOE_CASES = {"ep": ((2, 2), (4, 16)), "xp": ((1, 4), (2, 16))}


def make_inputs() -> dict:
    """Weights (the port's draws, in the reference's layout) and
    batches, the same for both packages."""
    rng = np.random.default_rng(7)
    inp = {"params": {}, "prompt": {}, "steps": {}, "moe": {}}
    for i, arch in enumerate(ARCHS):
        cfg = reduced_for_smoke(get_arch(arch).config)
        state = Model(cfg, seed=i, device="cpu").state_dict()
        tree = params_to_reference(state, cfg)
        inp["params"][arch] = _numpy_tree(tree)
        inp["prompt"][arch] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        inp["steps"][arch] = [rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
                              for _ in range(N_DECODE)]
    for mode, (_, (b, s)) in MOE_CASES.items():
        cfg = moe_cfg(mode)
        gen = torch.Generator().manual_seed(11)
        sd = {k: v.detach().numpy() for k, v in MoE(cfg, gen).state_dict().items()}
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        inp["moe"][mode] = (sd, x)
    return inp


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().numpy()


_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.distributed.sharding import use_sharding_rules
    from repro.launch.shardings import (make_sharding_rules, param_shardings,
                                        opt_state_shardings)
    from repro.models import blocks, model as M
    from repro.models.config import MoEConfig, reduced_for_smoke
    from repro.models.inputs import dummy_batch
    from repro.models.moe import moe_apply
    from repro.models.registry import get_arch
    from repro.optim.adamw import adamw_init
    from repro.runtime.steps import make_train_step

    inp = pickle.loads(open(sys.argv[1], "rb").read())
    ARCHS, DTYPES, B, S, MAX_LEN = eval(sys.argv[3])

    def mesh(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    def f32(x):
        x = jnp.asarray(x)
        return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)

    m22 = mesh((2, 2))
    rules = make_sharding_rules(m22)
    res = {}
    for arch in ARCHS:
        base = reduced_for_smoke(get_arch(arch).config)
        params = jax.tree.map(jnp.asarray, inp["params"][arch])
        params = jax.device_put(params, param_shardings(m22, rules, params))
        for dtype in DTYPES:
            cfg = base.scaled(dtype=dtype)
            with m22, use_sharding_rules(rules):
                (loss, met), grads = jax.jit(jax.value_and_grad(
                    lambda p, b: M.train_loss(p, b, cfg), has_aux=True))(
                    params, dummy_batch(cfg, B, S))
            res[(arch, dtype)] = (float(loss), {k: float(v) for k, v in met.items()},
                                  jax.tree.map(f32, grads))
        cfg = base.scaled(dtype="float32")
        for form, kv in (("served", jnp.bfloat16), ("f32 stores", jnp.float32)):
            blocks.attn_cache_init.__defaults__ = (kv, None)
            with m22, use_sharding_rules(rules):
                logits, c = jax.jit(lambda p, b: M.prefill(p, b, cfg, MAX_LEN))(
                    params, {"tokens": jnp.asarray(inp["prompt"][arch])})
                outs = [f32(logits)]
                step = jax.jit(lambda p, t, c: M.decode_step(p, t, c, cfg))
                for t in inp["steps"][arch]:
                    logits, c = step(params, jnp.asarray(t), c)
                    outs.append(f32(logits))
            res[(arch, form)] = outs
        blocks.attn_cache_init.__defaults__ = (jnp.bfloat16, None)
        if arch == "qwen2.5-3b":
            opt = adamw_init(params)
            opt = jax.device_put(opt, opt_state_shardings(m22, rules, opt))
            with m22, use_sharding_rules(rules):
                new_p, new_o, met = jax.jit(make_train_step(cfg))(
                    params, opt, dummy_batch(cfg, B, S))
            res["adamw"] = (jax.tree.map(f32, new_p), jax.tree.map(f32, new_o["m"]),
                            jax.tree.map(f32, new_o["v"]), float(met["grad_norm"]))

    for mode, (shape, cfg_args) in eval(sys.argv[4]).items():
        base = reduced_for_smoke(get_arch(cfg_args[0]).config).scaled(dtype="float32")
        if cfg_args[1]:
            base = base.scaled(moe=MoEConfig(n_experts=cfg_args[1], top_k=2))
        sd, x = inp["moe"][mode]
        p = {"norm": {"scale": jnp.asarray(sd["norm.scale"])},
             **{k: jnp.asarray(sd[k]) for k in ("router", "w_gate", "w_up", "w_down")}}
        mesh_ = mesh(shape)
        with mesh_, use_sharding_rules(make_sharding_rules(mesh_)):
            out, aux = jax.jit(lambda p, x: moe_apply(p, x, base))(p, jnp.asarray(x))
        res[("moe", mode)] = (f32(out), float(aux))
    open(sys.argv[2], "wb").write(pickle.dumps(res))
""")

_RANK = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.manager import restore_tree, save_tree
    from repro_torch.distributed.sharding import P, place, use_sharding_rules
    from repro_torch.launch.shardings import (make_sharding_rules, param_shardings,
                                              port_param_spec)
    from repro_torch.models import blocks, get_arch, reduced_for_smoke
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.inputs import dummy_batch
    from repro_torch.models.model import Model
    from repro_torch.models.moe import MoE
    from repro_torch.optim.adamw import adamw_init, apply_update, clip_scale, decay_mask
    from repro_torch.runtime.steps import make_lr_schedule, make_train_step

    rank, world = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], world),
                            rank=rank, world_size=world)
    inp = pickle.loads(open(sys.argv[6], "rb").read())
    ARCHS, DTYPES, B, S, MAX_LEN = eval(sys.argv[7])
    names = ("data", "model")
    m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=names)
    m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=names)
    m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=names)
    rules = make_sharding_rules(m22)

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def sharded_model(arch, dtype):
        cfg = reduced_for_smoke(get_arch(arch).config).scaled(dtype=dtype)
        model = Model(cfg, device="cpu")
        model.load_state_dict(params_from_reference(inp["params"][arch], cfg))
        param_shardings(m22, rules, model)
        return cfg, model

    res = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            cfg, model = sharded_model(arch, dtype)
            with use_sharding_rules(rules):
                loss, met = model.train_loss(dummy_batch(cfg, B, S))
            # outside the rules, as on autograd's device thread: the
            # recomputed groups bring the forward's rules with them
            loss.backward()
            grads = {n: (torch.zeros(p.shape) if p.grad is None
                         else full(p.grad).float()).numpy()
                     for n, p in model.named_parameters()}
            res[(arch, dtype)] = (float(loss), {k: float(v) for k, v in met.items()},
                                  grads)
        cfg, model = sharded_model(arch, "float32")
        for form, kv in (("served", torch.bfloat16), ("f32 stores", torch.float32)):
            blocks.attn_cache_init.__defaults__ = (kv, None, "cpu")
            with use_sharding_rules(rules):
                logits, caches = model.prefill({"tokens": inp["prompt"][arch]},
                                               MAX_LEN)
                outs = [full(logits).numpy()]
                for t in inp["steps"][arch]:
                    logits, caches = model.decode_step(torch.from_numpy(t), caches)
                    outs.append(full(logits).numpy())
                layouts = sorted({str(tuple(c.placements))
                                  for c in caches["layers"][0]["attn"].values()})
            res[(arch, form)] = (outs, layouts)
        blocks.attn_cache_init.__defaults__ = (torch.bfloat16, None, "cpu")
        if arch == "qwen2.5-3b":
            params = dict(model.named_parameters())
            before = {n: full(p).detach().clone() for n, p in params.items()}
            batch = dummy_batch(cfg, B, S)
            with use_sharding_rules(rules):
                model.train_loss(batch)[0].backward()
            grads = {n: full(p.grad).detach().clone() for n, p in params.items()}
            opt = adamw_init(params)
            with use_sharding_rules(rules):
                model, opt, met = make_train_step(cfg)(model, opt, batch)
            after = [{n: full(t).detach() for n, t in tree.items()}
                     for tree in (dict(model.named_parameters()), opt["m"], opt["v"])]
            # the same update of the same gradients on whole tensors
            plain = {n: t.clone() for n, t in before.items()}
            state = adamw_init(plain)
            apply_update(grads, state, plain, clip_scale(met["grad_norm"]),
                         make_lr_schedule(cfg)(torch.ones((), dtype=torch.int32)),
                         decay=decay_mask(plain, cfg))
            same = all(torch.equal(a[n], b[n]) for a, b in
                       zip(after, (plain, state["m"], state["v"])) for n in plain)
            res["adamw"] = ([{n: t.numpy() for n, t in tree.items()} for tree in after],
                            float(met["grad_norm"]), same)
            # elastic: saved from (2, 2), restored onto (4, 1)
            ck = sys.argv[4] + f".ckpt{rank}"
            save_tree(params, ck, 0, device="cpu")
            rules41 = make_sharding_rules(m41)
            shard41 = {n: (m41, place(torch.zeros(p.shape), m41, port_param_spec(
                m41, rules41, n, p.shape, cfg)).placements)
                for n, p in params.items()}
            restored, _ = restore_tree(params, ck, 0, shardings=shard41,
                                       device="cpu")
            res["elastic"] = (
                all(torch.equal(full(restored[n]), full(p).detach())
                    for n, p in params.items()),
                {n: (tuple(restored[n].device_mesh.shape), str(restored[n].placements))
                 for n in params})

    for mode, (shape, cfg_args) in eval(sys.argv[8]).items():
        cfg = reduced_for_smoke(get_arch(cfg_args[0]).config).scaled(dtype="float32")
        if cfg_args[1]:
            cfg = cfg.scaled(moe=MoEConfig(n_experts=cfg_args[1], top_k=2))
        mesh = m22 if shape == (2, 2) else m14
        r = make_sharding_rules(mesh)
        sd, x = inp["moe"][mode]
        moe = MoE(cfg, torch.Generator().manual_seed(0))
        for n, p in moe.named_parameters():
            *path, leaf = n.split(".")
            owner = moe.norm if path else moe
            spec = port_param_spec(mesh, r, "layers.0.moe." + n, p.shape, cfg)
            owner._parameters[leaf] = torch.nn.Parameter(
                place(torch.from_numpy(sd[n]), mesh, spec))
        with use_sharding_rules(r):
            out, aux = moe(place(torch.from_numpy(x), mesh, P(("data",), "model")))
        res[("moe", mode)] = (full(out).detach().numpy(), float(full(aux)))
    open(sys.argv[4], "wb").write(pickle.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
""")

MOE_ARGS = {"ep": ((2, 2), ("dbrx-132b", 0)), "xp": ((1, 4), ("mixtral-8x22b", 2))}


def _env():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4 ranks, started together
    once per module -> (reference results, port results of rank 0, every
    rank's losses)."""
    root = tmp_path_factory.mktemp("sharded_lm")
    inp = root / "inputs.pkl"
    inp.write_bytes(pickle.dumps(make_inputs()))
    consts = repr((ARCHS, DTYPES, B, S, MAX_LEN))
    moe = repr(MOE_ARGS)
    ref_out = root / "reference.pkl"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(inp), str(ref_out), consts, moe],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())]
    outs = [root / f"rank{r}.pkl" for r in range(4)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "4", str(root / "filestore"),
         str(outs[r]), str(HERE), str(inp), consts, moe],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
        for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    ranks = [pickle.loads(o.read_bytes()) for o in outs]
    return pickle.loads(ref_out.read_bytes()), ranks


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


@pytest.mark.parametrize("mode", sorted(MOE_CASES))
def test_sharded_moe_matches_shard_map(runs, mode):
    ref, ranks = runs
    out, aux = ref[("moe", mode)]
    for r in ranks:
        mine, mine_aux = r[("moe", mode)]
        assert mine.shape == out.shape
        # measured: ep 4.1e-7, xp 3.2e-7; aux equal
        assert _rel(mine, out) <= MOE_OUT, mode
        assert abs(mine_aux - aux) <= MOE_AUX * abs(aux), (mine_aux, aux)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_value_and_grad(runs, arch, dtype):
    ref, ranks = runs
    loss, metrics, grads = ref[(arch, dtype)]
    cfg = reduced_for_smoke(get_arch(arch).config)
    want = {k: v.numpy() for k, v in params_from_reference(grads, cfg).items()}
    f32 = dtype == "float32"
    for r in ranks:
        mloss, mmetrics, mgrads = r[(arch, dtype)]
        assert abs(mloss - loss) <= (F32_LOSS if f32 else BF16) * max(1.0, abs(loss))
        assert set(mmetrics) == set(metrics)
        for k, v in metrics.items():
            assert abs(mmetrics[k] - v) <= (F32_LOSS if f32 else BF16) * max(1.0, abs(v)), k
    mgrads = ranks[0][(arch, dtype)][2]
    assert set(mgrads) == set(want)
    # measured: f32 loss <= 9.8e-8, grads <= 6.1e-7; bf16 loss <= 1.5e-5,
    # grads <= 1.97e-2 (qwen's layers.1.attn.bk)
    for name, g in mgrads.items():
        assert np.isfinite(g).all(), name
        assert _rel(g, want[name]) <= (F32_GRAD if f32 else BF16), name


def test_sharded_adamw_step_matches_reference(runs):
    """The step's moments and global norm against the reference's step;
    its update against the same update of the same gradients on whole
    tensors (bit-equal; ``test_torch_train.py`` holds that update to the
    reference's bit for bit).  The parameters themselves are not held to
    the reference's: the first step moves each by about ``lr * sign(g)``,
    so a last-bit difference of a near-zero gradient moves a zero-started
    bias by a large part of its step."""
    ref, ranks = runs
    cfg = reduced_for_smoke(get_arch("qwen2.5-3b").config)
    *trees, gnorm = ref["adamw"]
    _, m, v = (params_from_reference(t, cfg) for t in trees)
    for r in ranks:
        (_, mm, mv), mine_gnorm, same = r["adamw"]
        assert same
        # measured: 2.0e-7; moments <= 1.07e-6
        assert abs(mine_gnorm - gnorm) <= F32_LOSS * gnorm, (mine_gnorm, gnorm)
        for want, got in ((m, mm), (v, mv)):
            assert set(want) == set(got)
            for name in want:
                assert _rel(got[name], want[name].numpy()) <= F32_GRAD, name


@pytest.mark.parametrize("form", ["f32 stores", "served"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_reference(runs, arch, form):
    """Logits of the prefill and 2 decode steps.  With every K/V store in
    f32 (both packages' ``attn_cache_init`` made to default to f32)
    within 5.1e-7 R; as served (bf16 stores) within ``test_torch_models``'
    1e-4 R: a K/V value at a bf16 rounding midpoint takes the other bf16
    step when its f32 value differs in the last bit (mixtral: 3 of 4096
    V entries after the prefill, also unsharded), and later steps carry
    it."""
    ref, ranks = runs
    want = ref[(arch, form)]
    outs, layouts = ranks[0][(arch, form)]
    assert len(outs) == len(want) == 1 + N_DECODE
    for got, w in zip(outs, want):
        assert got.shape == w.shape
        # measured: f32 stores <= 2.5e-7; served <= 4.1e-7, 6.4e-6 (mixtral)
        assert _rel(got, w) <= (SERVE if form == "f32 stores" else SERVED)
    # the caches live sharded: batch over data, heads (or sequence)
    # over model
    assert all("Shard(dim=0)" in lay for lay in layouts), layouts


def test_elastic_restore_onto_another_mesh_is_bit_equal(runs):
    _, ranks = runs
    for r in ranks:
        equal, placed = r["elastic"]
        assert equal
        assert all(shape == (4, 1) for shape, _ in placed.values())
        assert "Shard(dim=1)" in placed["embed"][1]  # fsdp over 'data' of 4
