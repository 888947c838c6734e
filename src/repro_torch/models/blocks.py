"""Per-layer blocks: attention (with its three cache forms) and the dense
FFN (port of ``repro.models.blocks``); MoE and the SSMs live in sibling
modules.  Each block is an ``nn.Module`` whose parameter names are the
reference's leaf names.  On DTensors (a model placed by
``launch.shardings``) each runs as a local region of ``parallel``."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..distributed.sharding import logical_constraint
from . import parallel
from .attention import blockwise_attention
from .common import Norm, apply_rope, cast_weight, cdtype, normal_init, param, pdtype

# ------------------------------------------------------------- attention


class Attention(torch.nn.Module):
    def __init__(self, cfg, gen: torch.Generator, device="cpu"):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        std = 0.02
        dt = pdtype(cfg)
        self.cfg = cfg
        self.norm = Norm(cfg, device)
        self.wq = param(normal_init(gen, (d, hq * hd), std, dt, device))
        self.wk = param(normal_init(gen, (d, hkv * hd), std, dt, device))
        self.wv = param(normal_init(gen, (d, hkv * hd), std, dt, device))
        self.wo = param(normal_init(gen, (hq * hd, d),
                                    std / np.sqrt(2 * cfg.n_layers), dt, device))
        if cfg.qkv_bias:
            self.bq = param(torch.zeros(hq * hd, dtype=dt, device=device))
            self.bk = param(torch.zeros(hkv * hd, dtype=dt, device=device))
            self.bv = param(torch.zeros(hkv * hd, dtype=dt, device=device))
        if cfg.post_norm:
            self.norm_post = Norm(cfg, device)

    def forward(self, x, *, window, cache=None, q_offset: int = 0):
        """x: (B, S, d). cache: None | dict(k, v[, k_scale, v_scale]),
        updated in place.  KV layout: (B, Hkv, Smax, D).  On DTensors the
        block runs as a local region (``parallel.attention``)."""
        if isinstance(x, DTensor):
            return parallel.attention(self, x, window=window, cache=cache,
                                      q_offset=q_offset)
        out = self.attend(x, window=window, cache=cache, q_offset=q_offset)
        if self.cfg.post_norm:
            out = self.norm_post(out)
        return out

    def attend(self, x, *, window, cache=None, q_offset: int = 0, heads=None,
               kv_heads=None, kv_slice=None):
        """The block before its post-norm, on local tensors: ``heads`` query
        and ``kv_heads`` K/V heads (default: all) from the weights as
        they are; the attention reads K/V heads ``kv_slice`` (lo, hi) of
        them (default: all)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hq = heads or cfg.n_heads
        hkv = kv_heads or cfg.n_kv_heads
        hd = cfg.hd
        ct = cdtype(cfg)
        h = self.norm(x)

        def proj(w, bias, nh):
            y = h @ cast_weight(self, w, ct)
            if hasattr(self, bias):
                y = y + cast_weight(self, bias, ct)
            return y.reshape(b, s, nh, hd).transpose(1, 2)

        q = proj("wq", "bq", hq)
        k = proj("wk", "bk", hkv)
        v = proj("wv", "bv", hkv)
        # the reference pins these layouts before the KV-block loop; its
        # region has pinned them here already
        q = logical_constraint(q, "batch", "heads", "seq_noshard", None)
        k = logical_constraint(k, "batch", "heads", "seq_noshard", None)
        v = logical_constraint(v, "batch", "heads", "seq_noshard", None)
        positions = q_offset + torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        k_start = 0
        kv_len = None
        k_scale = v_scale = None
        if cache is None:
            k_full, v_full = k, v
        elif window is not None and cache["k"].shape[2] <= window:
            # ring cache of a sliding-window layer: the last W positions,
            # right-aligned
            w_len = cache["k"].shape[2]
            kd = cache["k"].dtype
            if s > 1:  # prefill: attend within the prompt, keep the last W
                k_full, v_full = k, v
                take = min(s, w_len)
                cache["k"].zero_()
                cache["v"].zero_()
                cache["k"][:, :, w_len - take:] = k[:, :, s - take:].to(kd)
                cache["v"][:, :, w_len - take:] = v[:, :, s - take:].to(kd)
            else:  # decode: shift left, append, attend over the window
                for name, t in (("k", k), ("v", v)):
                    c = cache[name]
                    c[:, :, :-1] = c[:, :, 1:].clone()
                    c[:, :, -1:] = t.to(c.dtype)
                k_full, v_full = cache["k"], cache["v"]
                k_start = q_offset + s - w_len  # unfilled slots: k_pos < 0
        elif cache["k"].dtype == torch.int8:
            # int8 KV cache (cfg.kv_quant): symmetric per-(b, h, position)
            # scales
            at = _slot(cache["k"].shape[2], s, q_offset)
            for name, t in (("k", k), ("v", v)):
                q8, scale = quantize_int8(t)
                cache[name][:, :, at] = q8
                cache[name + "_scale"][:, :, at] = scale
            k_full, v_full = cache["k"], cache["v"]
            k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            kv_len = q_offset + s
        else:
            at = _slot(cache["k"].shape[2], s, q_offset)
            cache["k"][:, :, at] = k.to(cache["k"].dtype)
            cache["v"][:, :, at] = v.to(cache["v"].dtype)
            k_full, v_full = cache["k"], cache["v"]
            kv_len = q_offset + s
        if kv_slice is not None:
            lo, hi = kv_slice
            k_full, v_full = k_full[:, lo:hi], v_full[:, lo:hi]
            if k_scale is not None:
                k_scale, v_scale = k_scale[:, lo:hi], v_scale[:, lo:hi]

        out = blockwise_attention(
            q, k_full, v_full, causal=cfg.causal, q_offset=q_offset,
            window=window, cap=cfg.attn_softcap, kv_len=kv_len,
            k_start=k_start, k_scale=k_scale, v_scale=v_scale)
        out = out.transpose(1, 2).reshape(b, s, hq * hd)
        return out @ cast_weight(self, "wo", ct)


def _slot(length: int, s: int, q_offset: int) -> slice:
    """The positions a write of ``s`` steps at ``q_offset`` covers, its
    start clamped so the write fits (``dynamic_update_slice``)."""
    start = max(0, min(int(q_offset), length - s))
    return slice(start, start + s)


def quantize_int8(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(b, h, position) scales ``max|t| / 127`` (floored at 1e-20),
    codes rounded half to even and clipped to +-127."""
    t32 = t.float()
    scale = t32.abs().amax(-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-20)
    q8 = torch.clamp(torch.round(t32 / scale), -127, 127).to(torch.int8)
    return q8, scale


def attn_cache_init(cfg, batch, max_len, dtype=torch.bfloat16, window=None,
                    device="cpu") -> dict:
    eff = min(max_len, window) if window else max_len
    shape = (batch, cfg.n_kv_heads, eff, cfg.hd)
    if cfg.kv_quant and not window:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1] + (1,), device=device),
                "v_scale": torch.zeros(shape[:-1] + (1,), device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ------------------------------------------------------------------ FFN


def act(cfg, g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` / ``gelu`` (its default tanh form) / ``relu``."""
    if cfg.act.startswith("silu"):
        return F.silu(g)
    if cfg.act.startswith("gelu"):
        return F.gelu(g, approximate="tanh")
    return F.relu(g)


class FFN(torch.nn.Module):
    def __init__(self, cfg, gen: torch.Generator, device="cpu"):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = pdtype(cfg)
        std = 0.02
        self.cfg = cfg
        self.norm = Norm(cfg, device)
        if cfg.act.endswith("_glu"):
            self.w_gate = param(normal_init(gen, (d, ff), std, dt, device))
        self.w_up = param(normal_init(gen, (d, ff), std, dt, device))
        self.w_down = param(normal_init(gen, (ff, d),
                                        std / np.sqrt(2 * cfg.n_layers), dt,
                                        device))
        if cfg.post_norm:
            self.norm_post = Norm(cfg, device)

    def forward(self, x):
        if isinstance(x, DTensor):
            return parallel.ffn(self, x)
        out = self.mlp(x)
        if self.cfg.post_norm:
            out = self.norm_post(out)
        return out

    def mlp(self, x):
        """The FFN before its post-norm, with the weights as they are."""
        cfg = self.cfg
        ct = cdtype(cfg)
        h = self.norm(x)
        up = h @ cast_weight(self, "w_up", ct)
        if hasattr(self, "w_gate"):
            mid = act(cfg, h @ cast_weight(self, "w_gate", ct)) * up
        else:
            mid = act(cfg, up)
        mid = logical_constraint(mid, "batch", "seq_noshard", "ffn")
        return mid @ cast_weight(self, "w_down", ct)
