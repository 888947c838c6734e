"""Shared layer primitives: dtypes, norms, soft cap, RoPE, init, the
compute-dtype weight copies and the chunked cross-entropy (port of
``repro.models.common``).

Every op follows the reference's rounding: a product of two bf16 values
is exact in f32, so an f32 matmul of upcast bf16 operands is XLA's
``preferred_element_type=f32`` dot of the bf16 ones.

Parameters are trainable (``requires_grad``): a forward with grad
enabled builds the autograd graph through every weight, its
compute-dtype copy included; a ``no_grad`` or ``inference_mode``
forward (serving) reads the cached copy and records nothing.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed.tensor
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import sharding_rules, use_sharding_rules

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cdtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def pdtype(cfg) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def normal_init(gen: torch.Generator, shape, std, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """``N(0, std)`` drawn in f32 from ``gen`` (whose device is the
    tensor's), then cast: the reference's ``normal_init``.  On ``meta``
    (no generator) the tensor has a shape and no values."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32 from operands of any float dtype
    (XLA's dot with ``preferred_element_type=float32``)."""
    return torch.matmul(a.float(), b.float())


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (``jnp.asarray(value, dtype)``), as a
    Python float: a tensor times it computes in f32 and rounds once, as
    XLA's product of two ``dtype`` operands does."""
    return torch.tensor(value, dtype=dtype).item()


def cast_weight(module: torch.nn.Module, name: str,
                dtype: torch.dtype) -> torch.Tensor:
    """``module.<name>`` in ``dtype``: the reference's ``w.astype(ct)`` at
    every use.  With grad enabled and a weight that requires it, the
    cast is an op of the autograd graph (the gradient reaches the f32
    master weight, as through the reference's ``astype``).  Otherwise
    (serving) the copy is held once and rebuilt when the parameter is
    replaced or written in place (its storage or version changes; an
    inference tensor, made under ``torch.inference_mode``, has no
    version: its storage alone is checked)."""
    w = getattr(module, name)
    if w.dtype == dtype:
        return w
    if w.requires_grad and torch.is_grad_enabled():
        return w.to(dtype)
    cache = module.__dict__.setdefault("_cast", {})
    key = (name, dtype)
    stamp = (w.data_ptr(), None if w.is_inference() else w._version)
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, w.detach().to(dtype))
        cache[key] = hit
    return hit[1]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The variance accumulates in f32 from x's operands; the result is
    ``x * inv * (1 + scale)`` in x's dtype."""
    d = x.shape[-1]
    xf = x.float()
    var = (xf * xf).sum(-1) / d
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * (1.0 + scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps):
    d = x.shape[-1]
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    e2 = (xf * xf).sum(-1)[..., None] / d
    var = torch.clamp_min(e2 - mu * mu, 0.0)
    inv = torch.rsqrt(var + eps)
    out = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return out * scale.to(x.dtype) + bias.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ----------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D). positions: broadcastable to (..., S).  f32 math,
    half-split form."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(x.device)
    ang = positions.float()[..., None] * freqs  # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- norms

class Norm(torch.nn.Module):
    """``cfg.norm``'s parameters: ``scale`` (RMSNorm, zeros: the scale is
    ``1 + scale``), or ``scale`` and ``bias`` (LayerNorm, ones and zeros)."""

    def __init__(self, cfg, device="cpu"):
        super().__init__()
        self.kind = cfg.norm
        self.eps = cfg.norm_eps
        d = cfg.d_model
        if cfg.norm == "rmsnorm":
            self.scale = param(torch.zeros(d, device=device))
        else:
            self.scale = param(torch.ones(d, device=device))
            self.bias = param(torch.zeros(d, device=device))

    def forward(self, x):
        if isinstance(x, torch.distributed.tensor.DTensor):
            from . import parallel

            return parallel.norm(self, x)
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale, self.eps)
        return layernorm(x, self.scale, self.bias, self.eps)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    grad is enabled (the reference's ``jax.checkpoint``).  The recompute
    runs under the sharding rules of the forward: on CUDA the backward
    runs on autograd's device thread, which does not see this thread's
    rules."""
    if torch.is_grad_enabled():
        rules = sharding_rules()

        def run(*a):
            with use_sharding_rules(rules):
                return fn(*a)

        return checkpoint(run, *args, use_reentrant=False)
    return fn(*args)


# ----------------------------------------------- chunked cross-entropy

def chunked_xent(hidden, w_lm, labels, mask, chunk: int = 1024,
                 final_cap: float | None = None) -> torch.Tensor:
    """Causal-LM loss without ever holding (T, vocab) logits of more than
    one chunk.

    hidden: (B, S, d) in the compute dtype; w_lm: (d, V); labels/mask:
    (B, S).  Each chunk of the sequence computes f32 logits from the
    compute-dtype operands, the soft cap, ``logsumexp`` and the gathered
    label logit, and is recomputed in the backward pass (the reference's
    ``jax.checkpoint`` scan body).  Returns the masked mean (f32 0-d).
    """
    b, s, d = hidden.shape
    n_chunks = s // chunk if s % chunk == 0 else 1
    if s % chunk != 0:
        chunk = s
    w = w_lm.to(hidden.dtype)

    def body(hc, wc, yc, mc):
        logits = softcap(dot_f32(hc, wc), final_cap)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, yc[..., None].long())[..., 0]
        nll = (lse - ll) * mc
        return nll.sum(dtype=torch.float32), mc.sum(dtype=torch.float32)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        t, n = remat(body, hidden[:, sl], w, labels[:, sl], mask[:, sl])
        tot = tot + t
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)
