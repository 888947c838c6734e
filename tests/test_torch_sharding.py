"""The port's sharding rules and policy (``distributed.sharding``,
``launch.mesh``, ``launch.shardings``) against the reference's.

For every architecture at its published size, on the meshes (16, 16)
and (2, 16, 16) of ``launch.mesh`` and a small (2, 4), the spec of every
parameter, AdamW moment, batch leaf and cache leaf the port computes
equals the reference's ``launch.shardings`` spec of the same leaf,
computed on a ``jax.sharding.AbstractMesh`` (no devices).  The
reference stacks each pattern slot's leaves over the groups; its
stacked axis's entry is ``None`` and is dropped before comparing.
The port computes on its ``{axis: size}`` alone (no process group) and
builds its leaves on ``meta``.
"""
from __future__ import annotations

import re

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.launch import shardings as ref_sh
from repro.models import model as ref_model
from repro.models.inputs import train_batch_specs as ref_batch_specs
from repro.models.registry import ARCHITECTURES, SHAPES
from repro.models.registry import get_arch as ref_get_arch
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, drop_nondivisible, to_placements
from repro_torch.launch import shardings as sh
from repro_torch.models import get_arch
from repro_torch.models.inputs import train_batch_specs
from repro_torch.models.model import Model
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}


def _abstract(sizes: dict) -> AbstractMesh:
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _ref_specs(tree_shardings) -> dict:
    """``{'/'-joined path: spec tuple}`` of a tree of NamedShardings."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(
            tree_shardings, is_leaf=lambda x: hasattr(x, "spec")):
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(parts)] = tuple(s.spec)
    return out


def _pad(spec, ndim: int) -> tuple:
    """``spec`` with one entry per dim, a 1-tuple entry as its axis (the
    same sharding; JAX's ``PartitionSpec`` keeps the axis alone)."""
    entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                    for e in spec)
    return entries + (None,) * (ndim - len(entries))


def _port_name(path: str, cfg):
    """The port's names of the reference's leaf ``path`` and whether it is
    stacked (inverse of ``convert.params_from_reference``'s mapping)."""
    period = len(cfg.pattern)
    n_groups = cfg.n_layers // period
    m = re.match(r"groups/slot(\d+)/(.*)", path)
    if m:
        i, rest = int(m.group(1)), m.group(2).replace("/", ".")
        return [f"layers.{g * period + i}.{rest}" for g in range(n_groups)], True
    m = re.match(r"tail/(\d+)/(.*)", path)
    if m:
        j, rest = int(m.group(1)), m.group(2).replace("/", ".")
        return [f"layers.{n_groups * period + j}.{rest}"], False
    return [path.replace("/", ".")], False


_TREES: dict = {}


def _reference_trees(arch: str):
    if arch not in _TREES:
        cfg = ref_get_arch(arch).config
        params = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                                jax.random.key(0))
        _TREES[arch] = (params, jax.eval_shape(ref_adamw_init, params))
    return _TREES[arch]


CASES = [(a, m) for a in ARCHITECTURES for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_and_moment_specs_equal_the_reference(arch, mesh):
    sizes = MESHES[mesh]
    amesh = _abstract(sizes)
    cfg = get_arch(arch).config
    params, opt = _reference_trees(arch)
    ref_rules = ref_sh.make_sharding_rules(amesh)
    rules = sh.make_sharding_rules(sizes)
    model = Model(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}

    want = {}
    for path, spec in _ref_specs(ref_sh.param_shardings(amesh, ref_rules,
                                                        params)).items():
        names, stacked = _port_name(path, cfg)
        for n in names:
            want[n] = spec[1:] if stacked else spec
    assert set(want) == set(shapes)
    for n, shape in shapes.items():
        got = sh.port_param_spec(sizes, rules, n, shape, cfg)
        assert _pad(got, len(shape)) == _pad(want[n], len(shape)), n

    ref_opt = _ref_specs(ref_sh.opt_state_shardings(amesh, ref_rules, opt))
    assert ref_opt.pop("step") == ()
    seen = 0
    for path, spec in ref_opt.items():
        key, rest = path.split("/", 1)
        names, stacked = _port_name(rest, cfg)
        for name in names:
            got = sh.opt_spec(sizes, rules, key, name, shapes[name], cfg)
            want_spec = spec[1:] if stacked else spec
            assert _pad(got, len(shapes[name])) == _pad(want_spec, len(shapes[name])), \
                (key, name)
            seen += 1
    assert seen == 2 * len(shapes)
    assert sh.opt_spec(sizes, rules, "step", "step", (), cfg) == P()


@pytest.mark.parametrize("arch,mesh", CASES)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    sizes = MESHES[mesh]
    amesh = _abstract(sizes)
    spec_ = ref_get_arch(arch)
    ref_rules = ref_sh.make_sharding_rules(amesh)
    for shape in spec_.runnable_shapes():
        sh_ = SHAPES[shape]
        seq, batch = sh_["seq_len"], sh_["global_batch"]
        rcfg = spec_.config_for(shape)
        cfg = get_arch(arch).config_for(shape)
        ref_b = _ref_specs(ref_sh.batch_shardings(
            amesh, ref_rules, ref_batch_specs(rcfg, batch, seq)))
        for k, (shp, _) in train_batch_specs(cfg, batch, seq).items():
            assert _pad(sh.batch_spec(sizes, shp), len(shp)) == \
                _pad(ref_b[k], len(shp)), (shape, k)
        if sh_["kind"] != "decode":
            continue
        for kv_quant in (False, True):
            if kv_quant and (rcfg.window or not rcfg.uses_attention):
                continue
            rc = rcfg.scaled(kv_quant=kv_quant)
            pc = cfg.scaled(kv_quant=kv_quant)
            caches = jax.eval_shape(lambda: ref_model.init_cache(rc, batch, seq))
            ref_c = _ref_specs(ref_sh.cache_shardings(amesh, ref_rules, caches,
                                                      rc.n_kv_heads))
            port = Model(pc, device="meta").init_cache(batch, seq)
            leaves = sh.cache_leaves(port, pc)
            assert leaves
            for keys, ref_path, stacked, leaf in leaves:
                got = sh.port_cache_spec(sizes, ref_path, stacked, leaf.shape,
                                         pc.n_kv_heads)
                want = ref_c[ref_path]
                want = want[1:] if stacked else want
                assert _pad(got, leaf.ndim) == _pad(want, leaf.ndim), \
                    (shape, kv_quant, keys)


def test_drop_nondivisible():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert drop_nondivisible(sizes, P(("pod", "data"), "model"), (64, 48)) == \
        P(("pod", "data"), "model")
    # 122753 is odd, a decode seq of 1, 8 kv heads on 16, a size-1 axis
    assert drop_nondivisible(sizes, P("model", "data"), (122753, 64)) == P(None, "data")
    assert drop_nondivisible(sizes, P(("pod", "data"), "model"), (16, 1)) == P(None, None)
    assert drop_nondivisible(sizes, P(None, "model"), (4, 8)) == P(None, None)
    assert drop_nondivisible({"data": 1, "model": 2}, P("data", "model"), (4, 4)) == \
        P(None, "model")
    # trailing dims the spec does not name are unsharded
    assert drop_nondivisible(sizes, P("data"), (32, 5, 7)) == P("data", None, None)


def test_spec_to_placements():
    names = ("pod", "data", "model")
    assert to_placements(names, P(("pod", "data"), None, "model"), 3) == \
        (Shard(0), Shard(0), Shard(2))
    assert to_placements(names, P(None, "data"), 2) == (Replicate(), Shard(1), Replicate())
    assert to_placements(("data", "model"), P(), 2) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        to_placements(names, P(("data", "pod")), 1)
    with pytest.raises(ValueError, match="twice"):
        to_placements(names, P("model", "model"), 2)


def test_logical_constraint_is_a_no_op_without_rules():
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.sharding_rules() is None
    assert sharding.logical_constraint(x, "batch", "embed") is x
    rules = sh.make_sharding_rules({"data": 2, "model": 4})
    with sharding.use_sharding_rules(rules):
        assert sharding.sharding_rules() is rules
        # a plain tensor (inside a local region) is returned as is
        assert sharding.logical_constraint(x, "batch", "embed") is x
        assert rules.spec("batch", "seq", None) == P(("data",), "model", None)
    assert sharding.sharding_rules() is None


def test_reference_path_maps_layers_onto_groups():
    cfg = get_arch("zamba2-1.2b").config   # 38 layers = 6 x 6 + 2 tail
    assert sh.reference_path("layers.7.mamba.w_in", cfg) == \
        ("groups/slot1/mamba/w_in", cfg.n_layers // len(cfg.pattern))
    assert sh.reference_path("layers.37.mamba.w_in", cfg) == ("tail/1/mamba/w_in", 0)
    assert sh.reference_path("shared.attn.wq", cfg) == ("shared/attn/wq", 0)
    assert sh.reference_path("final_norm.scale", cfg) == ("final_norm/scale", 0)
