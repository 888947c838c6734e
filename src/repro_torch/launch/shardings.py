"""Sharding policy: parameter, optimizer, batch and cache specs, and their
placement as DTensors (port of ``repro.launch.shardings``).

Scheme: DP over ('pod','data'), TP/SP/EP over 'model', FSDP (ZeRO-3)
over 'data'.  Param rules are path-regex -> logical spec; stacked scan
dims (leading n_groups) are auto-skipped.  Any entry that does not
divide its dim is dropped (replicated), see
``distributed.sharding.drop_nondivisible``.

Specs are computed on the reference's leaf path and shape, so the regex
table stays the reference's word for word: the port's ``layers.{L}``
is ``groups/slot{L % period}`` stacked over the groups (or
``tail/{j}``), and the stacked axis, whose entry is always ``None``, is
dropped from the result.  ``mesh`` is a ``DeviceMesh`` or its ``{axis:
size}``: specs need no process group, placement does.
"""
from __future__ import annotations

import re

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import (
    P,
    ShardingRules,
    drop_nondivisible,
    local_shape,
    mesh_sizes,
    place,
    to_placements,
)
from .mesh import dp_axes

# path-regex -> tuple of logical axis names (applied to trailing dims).
# First match wins; order matters (moe before generic ffn).
PARAM_RULES = [
    # experts over 'model' (EP). When E does not divide |model| (mixtral
    # 8e on a 16-wide axis) the expert entry is dropped by the
    # divisibility rule and the d_ff entry takes the 'model' axis instead
    # (XP mode) — param_spec deduplicates left-to-right, so exactly one
    # of the two ever holds 'model'.
    (r"moe/(w_gate|w_up)$", ("ep", "fsdp", "tp_ffn")),
    (r"moe/w_down$", ("ep", "tp_ffn", "fsdp")),
    (r"moe/router$", (None, None)),
    (r"embed$", ("tp", "fsdp")),
    (r"img_proj$", ("fsdp", "tp")),
    (r"lm_head$", ("fsdp", "tp")),
    (r"attn/w[qkv]$", ("fsdp", "tp")),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"attn/b[qkv]$", ("tp",)),
    (r"(ffn/w_up|ffn/w_gate)$", ("fsdp", "tp")),
    (r"ffn/w_down$", ("tp", "fsdp")),
    (r"mamba/w_in$", ("fsdp", "tp")),
    (r"mamba/w_out$", ("tp", "fsdp")),
    (r"mamba/conv_w$", (None, "tp")),
    (r"mamba/conv_b$", ("tp",)),
    (r"rwkv/(w_r|w_k|w_v|w_g|cm_k|cm_r)$", ("fsdp", "tp")),
    (r"rwkv/(w_o|cm_v)$", ("tp", "fsdp")),
    (r"rwkv/w_decay_1$", ("fsdp", None)),
    (r"rwkv/w_decay_2$", (None, "fsdp")),
    (r"rwkv/mix$", (None, "fsdp")),
    (r"(norm|norm_post|final_norm|out_norm|ln_out)/(scale|bias)$", ("fsdp",)),
    (r".*", ()),  # everything else replicated
]


def logical_rules(mesh) -> dict:
    dp = dp_axes(mesh)
    return {
        "batch": dp,
        "seq": "model",          # sequence parallelism at layer boundaries
        "seq_noshard": None,
        "heads": "model",
        "ffn": "model",
        "embed": None,
        "vocab": "model",
        "experts": "model",
        # param-rule names
        "fsdp": "data",
        "tp": "model",
        "tp_ffn": "model",
        "ep": "model",
    }


def make_sharding_rules(mesh) -> ShardingRules:
    return ShardingRules(
        mesh=mesh,
        rules=logical_rules(mesh),
        ep_axis="model",
        dp_axes=dp_axes(mesh),
    )


def param_spec(mesh, rules: ShardingRules, path: str, shape) -> P:
    """The spec of the reference's leaf ``path`` ('/'-joined) of
    ``shape``."""
    for pattern, names in PARAM_RULES:
        if re.search(pattern, path):
            logical = names
            break
    # apply to trailing dims; leading (stacked scan) dims replicated
    lead = len(shape) - len(logical)
    if lead < 0:
        logical = logical[-len(shape):] if len(shape) else ()
        lead = 0
    entries = (None,) * lead + tuple(rules.rules.get(n) for n in logical)
    spec = drop_nondivisible(mesh, P(*entries), shape)
    # deduplicate mesh axes left-to-right (a dropped 'ep' frees 'model'
    # for 'tp_ffn'; a surviving one must win)
    seen: set = set()
    out = []
    for e in spec:
        names = e if isinstance(e, tuple) else (e,)
        if e is not None and any(n in seen for n in names):
            out.append(None)
            continue
        seen.update(n for n in names if n)
        out.append(e)
    return P(*out)


# ------------------------------------------- the port's names and shapes

def reference_path(name: str, cfg) -> tuple[str, int]:
    """The reference's leaf path of the port's parameter (or moment)
    ``name`` and the size of the stacked group axis it gains there (0:
    none).  ``layers.{L}`` of the grouped layers is ``groups/slot{i}``,
    the rest ``tail/{j}``; other names keep their parts."""
    parts = name.split(".")
    if "layers" not in parts:
        return "/".join(parts), 0
    at = parts.index("layers")
    period = len(cfg.pattern)
    n_groups = cfg.n_layers // period
    layer, rest = int(parts[at + 1]), parts[at + 2:]
    head = parts[:at]
    if layer < n_groups * period:
        return "/".join(head + [f"groups/slot{layer % period}"] + rest), n_groups
    return "/".join(head + [f"tail/{layer - n_groups * period}"] + rest), 0


def _unstacked(spec: P, stacked: int) -> P:
    if stacked:
        assert spec[0] is None, spec
        return P(*spec[1:])
    return spec


def port_param_spec(mesh, rules: ShardingRules, name: str, shape, cfg) -> P:
    """The spec of the port's parameter ``name`` of ``shape``: the
    reference's spec of the same leaf, its stacked axis dropped."""
    path, stacked = reference_path(name, cfg)
    full = ((stacked,) if stacked else ()) + tuple(shape)
    return _unstacked(param_spec(mesh, rules, path, full), stacked)


def opt_spec(mesh, rules: ShardingRules, key: str, name: str, shape, cfg) -> P:
    """The spec of the optimizer leaf ``opt[key][name]``: ``step`` is
    replicated; ``m``/``v`` (and ``ef``) share the parameter's rule."""
    if key == "step" or len(shape) == 0:
        return P()
    path, stacked = reference_path(name, cfg)
    ps = f"{key}/{path}"
    # m/<param path>, v/<param path> share the param rule
    ps = re.sub(r"^(m|v)/", "", ps)
    full = ((stacked,) if stacked else ()) + tuple(shape)
    return _unstacked(param_spec(mesh, rules, ps, full), stacked)


def batch_spec(mesh, shape) -> P:
    dp = dp_axes(mesh)
    if len(shape) == 1:
        spec = P(dp)
    elif len(shape) == 2:
        spec = P(dp, "model")           # (B, S) tokens: SP on seq
    else:
        spec = P(dp, "model", None)     # (B, S, d) frames/embeds
    return drop_nondivisible(mesh, spec, shape)


def cache_spec(mesh, path: str, shape, n_kv_heads: int) -> P:
    """KV caches: batch over DP; heads over 'model' when divisible, else
    seq over 'model' (gathered per layer in the attention's region).
    ``path`` is the leaf's '/'-joined path (its suffix picks the rule)."""
    dp = dp_axes(mesh)
    tp = mesh_sizes(mesh)["model"]
    heads_shardable = n_kv_heads % tp == 0 and n_kv_heads >= tp
    ps, nd = path, len(shape)
    if nd == 0:
        return P()
    if ps.endswith("/k") or ps.endswith("/v") or ps.endswith("_scale"):
        # (..., B, Hkv, S, D) and their int8-KV scale twins (..., 1)
        tail = (("model", None, None) if heads_shardable
                else (None, "model", None))
        entries = [None] * (nd - 4) + [dp, *tail]
    elif "conv" in ps:                                 # (..., B, K-1, ch)
        entries = [None] * (nd - 3) + [dp, None, "model"]
    elif "ssm" in ps or ps.endswith("state"):          # (..., B, H, p, n)
        entries = [None] * (nd - 4) + [dp, "model", None, None]
    elif "shift" in ps:                                # (..., B, 1, d)
        entries = [None] * (nd - 3) + [dp, None, None]
    elif nd >= 2:
        entries = [None] * (nd - 2) + [dp, None]
    else:
        entries = [None] * nd
    return drop_nondivisible(mesh, P(*entries), shape)


def cache_leaves(caches: dict, cfg):
    """``(port key path, reference path, stacked size, leaf)`` of every
    tensor leaf of the port's caches (``Model.init_cache``)."""
    period = len(cfg.pattern)
    n_groups = cfg.n_layers // period
    out = []

    def walk(tree, port, ref, stacked):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, port + (k,), f"{ref}/{k}", stacked)
            elif isinstance(v, torch.Tensor):
                out.append((port + (k,), f"{ref}/{k}", stacked, v))

    for layer, c in enumerate(caches["layers"]):
        if layer < n_groups * period:
            walk(c, ("layers", layer), f"groups/slot{layer % period}", n_groups)
        else:
            walk(c, ("layers", layer), f"tail/{layer - n_groups * period}", 0)
    for g, c in enumerate(caches.get("shared", [])):
        walk(c, ("shared", g), "shared", n_groups)
    return out


def port_cache_spec(mesh, ref_path: str, stacked: int, shape, n_kv_heads) -> P:
    full = ((stacked,) if stacked else ()) + tuple(shape)
    return _unstacked(cache_spec(mesh, ref_path, full, n_kv_heads), stacked)


# ------------------------------------------------------------- placement

def _module_leaf(model, name):
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


def param_shardings(mesh, rules: ShardingRules, model, *, device=None) -> dict:
    """Place ``model``'s parameters as DTensors laid out by their specs, in
    place, and return ``{name: (mesh, placements)}`` (the form
    ``checkpoint.restore_tree(shardings=)`` takes).

    A parameter that every rank holds whole keeps this rank's block.  A
    ``meta`` model with ``device`` given gets its local blocks allocated
    there alone (the whole tensors never exist), drawn ``N(0, 0.02)``
    from seed 0; without ``device`` it stays on ``meta``."""
    cfg = model.cfg
    gen = None
    if device is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    out = {}
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is placed already")
        spec = port_param_spec(mesh, rules, name, p.shape, cfg)
        pl = to_placements(mesh, spec, p.ndim)
        if p.is_meta:
            shape = local_shape(p.shape, mesh, pl)
            if device is None:
                local = torch.empty(shape, dtype=p.dtype, device="meta")
            else:
                local = (torch.randn(shape, generator=gen, device=device) * 0.02
                         ).to(p.dtype)
            t = DTensor.from_local(local, mesh, pl, run_check=False)
        else:
            t = place(p.detach(), mesh, spec)
        mod, leaf = _module_leaf(model, name)
        mod._parameters[leaf] = torch.nn.Parameter(t, requires_grad=p.requires_grad)
        out[name] = (mesh, pl)
    return out


def opt_state_shardings(mesh, rules: ShardingRules, opt: dict, cfg) -> dict:
    """Place the AdamW state's moment trees (``m``, ``v``, ``ef``) like
    their parameters, in place (``step`` stays a host scalar); returns
    ``{key: {name: (mesh, placements)}}``."""
    out = {}
    for key, tree in opt.items():
        if not isinstance(tree, dict):
            continue
        out[key] = {}
        for name, t in list(tree.items()):
            spec = opt_spec(mesh, rules, key, name, t.shape, cfg)
            if not isinstance(t, DTensor):
                if t.is_meta:
                    pl = to_placements(mesh, spec, t.ndim)
                    t = DTensor.from_local(
                        torch.empty(local_shape(t.shape, mesh, pl),
                                    dtype=t.dtype, device="meta"),
                        mesh, pl, run_check=False)
                else:
                    t = place(t, mesh, spec)
                tree[name] = t
            out[key][name] = (mesh, tuple(t.placements))
    return out


def batch_shardings(mesh, rules: ShardingRules, batch: dict) -> dict:
    """The batch (every rank holds all of it) as DTensors: 1-D over DP,
    (B, S) with SP on seq, (B, S, d) likewise."""
    return {k: (v if isinstance(v, DTensor)
                else place(torch.as_tensor(v), mesh, batch_spec(mesh, v.shape)))
            for k, v in batch.items()}


def cache_shardings(mesh, rules: ShardingRules, caches: dict, n_kv_heads: int,
                    cfg) -> dict:
    """Place the caches' leaves (``Model.init_cache``) as DTensors, in
    place; returns the caches."""
    for keys, ref, stacked, leaf in cache_leaves(caches, cfg):
        spec = port_cache_spec(mesh, ref, stacked, leaf.shape, n_kv_heads)
        node = caches
        for k in keys[:-1]:
            node = node[k]
        if isinstance(leaf, DTensor):
            continue
        if leaf.is_meta:
            pl = to_placements(mesh, spec, leaf.ndim)
            node[keys[-1]] = DTensor.from_local(
                torch.empty(local_shape(leaf.shape, mesh, pl),
                            dtype=leaf.dtype, device="meta"),
                mesh, pl, run_check=False)
        else:
            node[keys[-1]] = place(leaf, mesh, spec)
    return caches
