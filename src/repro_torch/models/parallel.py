"""The LM on DTensors: each layer runs as one explicit local region.

The reference leaves the sharded forward to GSPMD under its logical
constraints (``distributed.sharding.logical_constraint``) and writes the
MoE's ``shard_map`` by hand.  The port writes every layer the way the
MoE is written: a ``Region`` redistributes the layer's DTensor inputs to
the layouts the constraints name (activations: batch over DP, sequence
gathered; weights: FSDP's ``data`` axis gathered, heads / FFN columns /
vocabulary kept over ``model``), the layer's single-device code runs on
the local tensors (its parameters swapped for their local blocks), and
the result leaves as a DTensor, a pending sum over ``model`` where the
contraction was split there, which the next layer-boundary constraint
reduce-scatters.  Tensors a layer makes (RoPE tables, positions, masks,
zero buffers) are made inside its region from local tensors, so no op
mixes a plain tensor with a DTensor.

When a dim does not divide its mesh axis the region keeps that tensor
whole over the axis, as the reference's ``drop_nondivisible`` does:
attention heads when ``n_heads`` (or the GQA grouping) does not divide
``model``, FFN columns, vocabulary.  The recurrent blocks (mamba2,
rwkv6) have no TP rule in the reference's activations; their region
splits the batch over DP only.  Caches are written where they live: a
leaf laid out as the region needs it is written in place, any other is
gathered, written and its own block copied back (``CacheView``).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import (
    CacheView,
    P,
    Region,
    _axis_size,
    drop_nondivisible,
    logical_constraint,
    sharding_rules,
    to_placements,
)
from .common import dot_f32, softcap


def rules():
    r = sharding_rules()
    if r is None or r.mesh is None:
        raise RuntimeError("a model on DTensors runs under the sharding rules "
                           "of its mesh: distributed.sharding."
                           "use_sharding_rules(launch.shardings."
                           "make_sharding_rules(mesh))")
    return r


@contextmanager
def local_params(module: torch.nn.Module, tensors: dict):
    """``module``'s parameters named in ``tensors`` (dotted names) read as
    the given local tensors while the block runs."""
    saved = []
    try:
        for name, t in tensors.items():
            *path, leaf = name.split(".")
            owner = module
            for p in path:
                owner = getattr(owner, p)
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


def batch_entry(r, b: int):
    """The DP axes the batch of ``b`` splits over, or None."""
    return drop_nondivisible(r.mesh, r.spec("batch"), (b,))[0]


def _axes(entry) -> set:
    if entry is None:
        return set()
    return set(entry if isinstance(entry, tuple) else (entry,))


def _tp(r, logical: str, dim: int):
    """The mesh axis ``logical`` names when it divides ``dim``, else None."""
    axis = r.rules.get(logical)
    size = _axis_size(r.mesh, axis)
    return axis if size > 1 and dim % size == 0 else None


def _norm_weights(reg: Region, norm, prefix: str) -> dict:
    return {f"{prefix}.{k}": reg.enter(p, P(None))
            for k, p in norm.named_parameters(recurse=False)}


def _cache_views(cache, mesh, spec: P):
    """A block's cache leaves as the local tensors its region writes."""
    if cache is None:
        return {}, None
    views = {k: CacheView(c, mesh, spec) for k, c in cache.items()}
    return views, {k: v.local for k, v in views.items()}


def _commit(views: dict, local) -> None:
    for k, v in views.items():
        v.commit(local[k])


def _boundary(x):
    return logical_constraint(x, "batch", "seq", "embed")


# ------------------------------------------------------------------ norm

def norm(mod, x: DTensor) -> DTensor:
    """A norm of a DTensor: token-local, so it runs on ``x``'s own blocks
    with the scale (and bias) gathered."""
    r = rules()
    if any(p.is_partial() for p in x.placements):
        x = _boundary(x)
    reg = Region(r.mesh, {n for n, p in zip(r.mesh.mesh_dim_names, x.placements)
                          if p.is_shard()})
    xl = x.to_local()
    w = {k: reg.enter(p, P(None)) for k, p in mod.named_parameters(recurse=False)}
    with local_params(mod, w):
        out = mod(xl)
    return DTensor.from_local(out, r.mesh, x.placements, run_check=False)


# ------------------------------------------------------------- attention

def attention(mod, x: DTensor, *, window, cache, q_offset) -> DTensor:
    """The attention block (before its residual) on DTensors: heads over
    ``model`` when the query heads and their GQA groups divide it (the
    K/V heads too when they divide), else whole; the output projection's
    pending sum is reduced at the layer boundary."""
    r = rules()
    mesh, cfg = r.mesh, mod.cfg
    b = x.shape[0]
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    tp = r.rules["heads"]
    m = _axis_size(mesh, tp)
    n = hq // m if (m > 1 and hq % m == 0) else 0
    q_sh = n > 0 and (n % g == 0 or g % n == 0)
    kv_sh = q_sh and hkv % m == 0
    bspec = batch_entry(r, b)
    reg = Region(mesh, _axes(bspec) | ({tp} if q_sh else set()))
    xl = reg.enter(x, P(bspec, None, None))
    col = P(None, tp if q_sh else None)
    kv_col = P(None, tp if kv_sh else None)
    w = {"wq": reg.enter(mod.wq, col), "wk": reg.enter(mod.wk, kv_col),
         "wv": reg.enter(mod.wv, kv_col),
         "wo": reg.enter(mod.wo, P(tp if q_sh else None, None)),
         **_norm_weights(reg, mod.norm, "norm")}
    if cfg.qkv_bias:
        w["bq"] = reg.enter(mod.bq, P(col[1]))
        w["bk"] = reg.enter(mod.bk, P(kv_col[1]))
        w["bv"] = reg.enter(mod.bv, P(kv_col[1]))
    kv_slice = None
    if q_sh and not kv_sh:
        # this rank's query heads [a, a + n) read K/V heads a // g ...
        a = reg.coordinate(tp) * n
        kv_slice = (a // g, (a + n - 1) // g + 1)
    views, local = _cache_views(cache, mesh, P(bspec, tp if kv_sh else None))
    with local_params(mod, w):
        out = mod.attend(xl, window=window, cache=local, q_offset=q_offset,
                         heads=n if q_sh else hq,
                         kv_heads=hkv // m if kv_sh else hkv, kv_slice=kv_slice)
    _commit(views, local)
    out = _boundary(reg.leave(out, P(bspec, None, None),
                              partial=(tp,) if q_sh else ()))
    return mod.norm_post(out) if cfg.post_norm else out


# ------------------------------------------------------------------- FFN

def ffn(mod, x: DTensor) -> DTensor:
    """The dense FFN on DTensors: its hidden columns over ``model`` (the
    reference's ``ffn`` constraint on the middle), the down projection's
    pending sum reduced at the layer boundary."""
    r = rules()
    mesh, cfg = r.mesh, mod.cfg
    tp = _tp(r, "ffn", cfg.d_ff)
    bspec = batch_entry(r, x.shape[0])
    reg = Region(mesh, _axes(bspec) | ({tp} if tp else set()))
    xl = reg.enter(x, P(bspec, None, None))
    w = {"w_up": reg.enter(mod.w_up, P(None, tp)),
         "w_down": reg.enter(mod.w_down, P(tp, None)),
         **_norm_weights(reg, mod.norm, "norm")}
    if hasattr(mod, "w_gate"):
        w["w_gate"] = reg.enter(mod.w_gate, P(None, tp))
    with local_params(mod, w):
        out = mod.mlp(xl)
    out = _boundary(reg.leave(out, P(bspec, None, None),
                              partial=(tp,) if tp else ()))
    return mod.norm_post(out) if cfg.post_norm else out


# ------------------------------------------------------ recurrent blocks

def replicated_block(mod, x: DTensor, cache) -> DTensor:
    """A block with no TP rule (mamba2, rwkv6): the batch over DP, every
    weight and the rest of each cache leaf gathered."""
    r = rules()
    mesh = r.mesh
    bspec = batch_entry(r, x.shape[0])
    reg = Region(mesh, _axes(bspec))
    xl = reg.enter(x, P(bspec, None, None))
    w = {k: reg.enter(p, P()) for k, p in mod.named_parameters()}
    views, local = _cache_views(cache, mesh, P(bspec))
    with local_params(mod, w):
        out = mod(xl, cache=local)
    _commit(views, local)
    return _boundary(reg.leave(out, P(bspec, None, None)))


# ------------------------------------------------------- embed and head

def _vocab_weight(model, reg: Region, tp):
    """The head's (d, V) weight as this rank's local block: the tied
    embedding's transpose or ``lm_head``, vocabulary over ``tp``."""
    if model.cfg.tie_embeddings:
        return reg.enter(model.embed, P(tp, None)).T
    return reg.enter(model.lm_head, P(None, tp))


def embed_tokens(model, tokens: DTensor, ct: torch.dtype) -> DTensor:
    """Token embeddings in the compute dtype: each rank looks up the ids in
    its vocabulary block (zeros elsewhere), a pending sum over ``model``
    that the boundary constraint reduces (exact: one term is nonzero)."""
    r = rules()
    v = model.cfg.vocab
    tp = _tp(r, "vocab", v)
    bspec = batch_entry(r, tokens.shape[0])
    reg = Region(r.mesh, _axes(bspec) | ({tp} if tp else set()))
    ids = reg.enter(tokens, P(bspec, None)).long()
    w = reg.enter(model.embed, P(tp, None)).to(ct)
    if tp is None:
        return _boundary(reg.leave(w[ids], P(bspec, None, None)))
    rows = w.shape[0]
    ids = ids - reg.coordinate(tp) * rows
    own = (ids >= 0) & (ids < rows)
    out = torch.where(own[..., None], w[ids.clamp(0, rows - 1)], w.new_zeros(()))
    return _boundary(reg.leave(out, P(bspec, None, None), partial=(tp,)))


def project_image(model, image: DTensor, ct: torch.dtype) -> DTensor:
    """llava's patch embeddings through ``img_proj`` (whole), per batch
    block; the sequence stays whole for the concatenation."""
    r = rules()
    bspec = batch_entry(r, image.shape[0])
    reg = Region(r.mesh, _axes(bspec))
    xl = reg.enter(image, P(bspec, None, None)).to(ct)
    w = reg.enter(model.img_proj, P(None, None)).to(ct)
    return reg.leave(xl @ w, P(bspec, None, None))


def head(model, h: DTensor, pos, dtype: torch.dtype, cap) -> DTensor:
    """Logits over the vocabulary, sharded over ``model`` on it: of the
    position ``pos`` (or of all positions when None), in ``dtype``, soft
    capped at ``cap``."""
    r = rules()
    tp = _tp(r, "vocab", model.cfg.vocab)
    bspec = batch_entry(r, h.shape[0])
    reg = Region(r.mesh, _axes(bspec) | ({tp} if tp else set()))
    hl = reg.enter(h, P(bspec, None, None))
    if pos is not None:
        hl = hl[:, pos]
    logits = softcap(hl.to(dtype) @ _vocab_weight(model, reg, tp).to(dtype), cap)
    mid = (None,) if pos is None else ()
    return reg.leave(logits, P(bspec, *mid, tp))


def _reduce(reg: Region, t: torch.Tensor, spec: P, axis: str, op: str):
    """``t`` reduced with ``op`` over ``axis`` (through DTensor), local."""
    full = reg.leave(t, spec, partial=(axis,), reduce=op)
    return full.redistribute(reg.mesh, reg.placements(spec, t.ndim)).to_local()


def chunked_xent(model, h: DTensor, labels, mask, chunk: int = 1024,
                 final_cap=None) -> torch.Tensor:
    """``common.chunked_xent`` with the vocabulary over ``model``: each
    rank's chunk logits cover its vocabulary block, and the log-sum-exp's
    max and sum and the label logit are reduced over ``model``.  Returns
    the masked mean as a plain 0-d f32 tensor (the same on every rank;
    its backward runs the collectives on every rank)."""
    from .common import remat

    r = rules()
    b, s, _ = h.shape
    n_chunks = s // chunk if s % chunk == 0 else 1
    if s % chunk != 0:
        chunk = s
    tp = _tp(r, "vocab", model.cfg.vocab)
    bspec = batch_entry(r, b)
    reg = Region(r.mesh, _axes(bspec) | ({tp} if tp else set()))
    hl = reg.enter(h, P(bspec, None, None))
    w = _vocab_weight(model, reg, tp).to(hl.dtype)
    yl = reg.enter(labels, P(bspec, None)).long()
    ml = reg.enter(mask, P(bspec, None))
    row = P(bspec, None)
    lo = reg.coordinate(tp) * w.shape[1] if tp else 0

    def body(hc, wc, yc, mc):
        logits = softcap(dot_f32(hc, wc), final_cap)
        mx = logits.detach().amax(-1)
        idx = yc - lo
        own = (idx >= 0) & (idx < wc.shape[1])
        ll = torch.where(own, logits.gather(-1, idx.clamp(0, wc.shape[1] - 1)
                                            [..., None])[..., 0], 0.0)
        if tp:
            mx = _reduce(reg, mx, row, tp, "max")
        se = torch.exp(logits - mx[..., None]).sum(-1)
        if tp:
            se = _reduce(reg, se, row, tp, "sum")
            ll = _reduce(reg, ll, row, tp, "sum")
        nll = (torch.log(se) + mx - ll) * mc
        return nll.sum(dtype=torch.float32), mc.sum(dtype=torch.float32)

    tot = torch.zeros((), dtype=torch.float32, device=hl.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hl.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        t, n = remat(body, hl[:, sl], w, yl[:, sl], ml[:, sl])
        tot = tot + t
        cnt = cnt + n
    dp = tuple(_axes(bspec))
    rep = to_placements(r.mesh, P(), 0)
    tot = reg.leave(tot, P(), partial=dp).redistribute(r.mesh, rep).to_local()
    cnt = reg.leave(cnt, P(), partial=dp).redistribute(r.mesh, rep).to_local()
    return tot / torch.clamp(cnt, min=1.0)
