"""Model assembly: embeddings -> blocks -> head, with the serving caches
(port of ``repro.models.model``'s ``init_params``, ``init_cache``,
``prefill`` and ``decode_step``).

``cfg.pattern`` is one *group* of block kinds, repeated ``n_layers //
len(pattern)`` times; the ``n_layers % len(pattern)`` leftover blocks
are the tail (zamba2's 38 = 6x6 + 2).  A shared attention+FFN block
(zamba2) runs at the start of every group with one set of weights and a
KV cache per group.  The reference stacks each pattern slot's weights
over the groups for ``lax.scan``; the port holds one module per layer,
``layers[g * len(pattern) + i]`` for group ``g``, slot ``i``
(``convert.params_from_reference`` maps the one onto the other), and
loops over them.

The caches are a dict ``{"layers": [per-layer cache], "len": int}``
(plus ``"shared"``: a cache per group), updated in place by each step.
"""
from __future__ import annotations

import torch

from ..engine.engine import resolve_device
from .blocks import FFN, Attention, attn_cache_init
from .common import (
    Norm,
    cast_weight,
    cdtype,
    normal_init,
    param,
    pdtype,
    scalar,
    softcap,
)
from .config import ModelConfig
from .mamba2 import Mamba2, mamba2_cache_init
from .moe import MoE
from .rwkv6 import RWKV6, rwkv6_cache_init


def has_shared(cfg: ModelConfig) -> bool:
    return any(k == "mamba2" for k in cfg.pattern) and cfg.uses_attention is False \
        and cfg.name.startswith("zamba")


class Block(torch.nn.Module):
    """One residual block of ``kind``."""

    def __init__(self, cfg, kind: str, gen, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.rs = scalar(cfg.residual_scale, cdtype(cfg))
        if kind in ("attn", "attn_local"):
            self.attn = Attention(cfg, gen, device)
            if cfg.moe is not None:
                self.moe = MoE(cfg, gen, device)
            else:
                self.ffn = FFN(cfg, gen, device)
        elif kind == "mamba2":
            self.mamba = Mamba2(cfg, gen, device)
        elif kind == "rwkv6":
            self.rwkv = RWKV6(cfg, gen, device)
        else:
            raise ValueError(kind)

    def forward(self, h, cache, q_offset):
        """Returns (h, aux)."""
        cfg, kind, rs = self.cfg, self.kind, self.rs
        aux = 0.0
        if kind in ("attn", "attn_local"):
            window = cfg.window if kind == "attn_local" else None
            delta = self.attn(h, window=window,
                              cache=None if cache is None else cache["attn"],
                              q_offset=q_offset)
            h = h + rs * delta
            if hasattr(self, "moe"):
                delta, aux = self.moe(h)
            else:
                delta = self.ffn(h)
            return h + rs * delta, aux
        key, mod = (("mamba", self.mamba) if kind == "mamba2"
                    else ("rwkv", self.rwkv))
        delta = mod(h, cache=None if cache is None else cache[key])
        return h + rs * delta, aux


def block_cache(cfg, kind, batch, max_len, device) -> dict:
    if kind in ("attn", "attn_local"):
        window = cfg.window if (kind == "attn_local" and cfg.window) else None
        return {"attn": attn_cache_init(cfg, batch, max_len, window=window,
                                        device=device)}
    if kind == "mamba2":
        return {"mamba": mamba2_cache_init(cfg, batch, device)}
    if kind == "rwkv6":
        return {"rwkv": rwkv6_cache_init(cfg, batch, device)}
    raise ValueError(kind)


class Model(torch.nn.Module):
    """One architecture config's weights (f32 by default, made from
    ``seed`` through a ``torch.Generator`` on ``device``), served through
    ``prefill`` and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dt = pdtype(cfg)
        self.cfg = cfg
        self.embed = param(normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, dt, dev))
        if cfg.input_kind == "tokens+image":
            self.img_proj = param(normal_init(gen, (cfg.d_model, cfg.d_model),
                                              0.02, dt, dev))
        self.layers = torch.nn.ModuleList(
            Block(cfg, kind, gen, dev) for kind in cfg.block_kinds)
        if has_shared(cfg):
            self.shared = torch.nn.Module()
            self.shared.attn = Attention(cfg, gen, dev)
            self.shared.ffn = FFN(cfg, gen, dev)
        self.final_norm = Norm(cfg, dev)
        if not cfg.tie_embeddings or cfg.encoder_only:
            self.lm_head = param(normal_init(gen, (cfg.d_model, cfg.vocab),
                                             0.02, dt, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----------------------------------------------------------- caches

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        caches = {"layers": [block_cache(cfg, kind, batch, max_len, dev)
                             for kind in cfg.block_kinds],
                  "len": 0}
        if has_shared(cfg):
            n_groups = cfg.n_layers // len(cfg.pattern)
            caches["shared"] = [
                {"attn": attn_cache_init(cfg, batch, max_len, window=cfg.window,
                                         device=dev)}
                for _ in range(n_groups)]
        return caches

    # ---------------------------------------------------------- forward

    def _apply_shared(self, h, cache, q_offset):
        # zamba2's shared block; honors cfg.window when a serve config
        # sets one
        delta = self.shared.attn(h, window=self.cfg.window,
                                 cache=None if cache is None else cache["attn"],
                                 q_offset=q_offset)
        h = h + delta
        return h + self.shared.ffn(h)

    def forward_hidden(self, h, caches=None, q_offset: int = 0):
        """h: (B, S, d) embedded inputs. Returns (hidden, aux); the caches
        are updated in place."""
        cfg = self.cfg
        period = len(cfg.pattern)
        grouped = (cfg.n_layers // period) * period
        shared = has_shared(cfg)
        aux = 0.0
        for i, block in enumerate(self.layers):
            if shared and i < grouped and i % period == 0:
                h = self._apply_shared(
                    h, None if caches is None else caches["shared"][i // period],
                    q_offset)
            h, a = block(h, None if caches is None else caches["layers"][i],
                         q_offset)
            aux = aux + a
        if caches is not None:
            caches["len"] += h.shape[1]
        return self.final_norm(h), aux

    def embed_inputs(self, batch: dict) -> torch.Tensor:
        cfg, dev = self.cfg, self.device
        ct = cdtype(cfg)
        if cfg.input_kind == "frames":
            h = batch["frames"].to(dev).to(ct)
        elif cfg.input_kind == "tokens+image":
            img = (batch["image_embeds"].to(dev).to(ct)
                   @ cast_weight(self, "img_proj", ct))
            tok = cast_weight(self, "embed", ct)[batch["tokens"].to(dev).long()]
            h = torch.cat([img, tok], dim=1)
        else:
            h = cast_weight(self, "embed", ct)[batch["tokens"].to(dev).long()]
        return h * scalar(cfg.embed_scale, ct)

    def lm_head_weight(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.T
        return self.lm_head

    def _logits(self, h_last):
        """The head in f32, then the final soft cap."""
        logits = h_last.float() @ self.lm_head_weight().float()
        return softcap(logits, self.cfg.final_softcap)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """Run the prompt through the model, filling fresh caches.
        Returns (last-position logits (B, V) f32, caches)."""
        h = self.embed_inputs(batch)
        caches = self.init_cache(h.shape[0], max_len)
        h, _ = self.forward_hidden(h, caches, q_offset=0)
        return self._logits(h[:, -1]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: dict):
        """One serving step: token (B,) -> logits (B, V); the caches
        advance in place (and are returned)."""
        cfg, dev = self.cfg, self.device
        ct = cdtype(cfg)
        h = cast_weight(self, "embed", ct)[token.to(dev).long()][:, None]
        h = h * scalar(cfg.embed_scale, ct)
        h, _ = self.forward_hidden(h, caches, q_offset=caches["len"])
        return self._logits(h[:, 0]), caches


def clone_cache(caches: dict) -> dict:
    """A deep copy of ``caches`` (every tensor cloned)."""
    if isinstance(caches, dict):
        return {k: clone_cache(v) for k, v in caches.items()}
    if isinstance(caches, list):
        return [clone_cache(v) for v in caches]
    return caches.clone() if isinstance(caches, torch.Tensor) else caches
