"""Model assembly: embeddings -> blocks -> head, with the serving caches
and the training loss (port of ``repro.models.model``'s
``init_params``, ``init_cache``, ``prefill``, ``decode_step`` and
``train_loss``).

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
from torch.distributed.tensor import DTensor

from ..distributed.sharding import logical_constraint
from ..engine.engine import resolve_device
from . import parallel
from .blocks import FFN, Attention, attn_cache_init
from .common import (
    Norm,
    cast_weight,
    cdtype,
    chunked_xent,
    normal_init,
    param,
    pdtype,
    remat,
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
            h = logical_constraint(h, "batch", "seq", "embed")
            if hasattr(self, "moe"):
                delta, aux = self.moe(h)
            else:
                delta = self.ffn(h)
            h = h + rs * delta
        else:
            key, mod = (("mamba", self.mamba) if kind == "mamba2"
                        else ("rwkv", self.rwkv))
            delta = mod(h, cache=None if cache is None else cache[key])
            h = h + rs * delta
        return logical_constraint(h, "batch", "seq", "embed"), aux


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
    ``prefill`` and ``decode_step`` and trained through ``train_loss``.

    On ``device="meta"`` the weights have shapes and no values (no draws,
    no memory): ``launch.shardings.param_shardings`` places them on a
    mesh and can materialize one rank's blocks.  A model whose weights
    are DTensors runs under the mesh's sharding rules
    (``distributed.sharding.use_sharding_rules``), every layer as a local
    region (``models.parallel``); its batch may be given whole (every
    rank the same), and is placed by ``launch.shardings.batch_shardings``.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if torch.device(device).type == "meta":
            dev, gen = torch.device("meta"), None
        else:
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

    @property
    def sharded(self) -> bool:
        """Whether the weights are DTensors (``param_shardings``)."""
        return isinstance(self.embed, DTensor)

    def _place_batch(self, batch: dict) -> dict:
        from ..launch.shardings import batch_shardings

        r = parallel.rules()
        dev = self.embed.to_local().device
        return batch_shardings(r.mesh, r, {
            k: (v if isinstance(v, DTensor) else torch.as_tensor(v).to(dev))
            for k, v in batch.items()})

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
        if self.sharded:
            from ..launch.shardings import cache_shardings

            r = parallel.rules()
            cache_shardings(r.mesh, r, caches, cfg.n_kv_heads, cfg)
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
        are updated in place.  With grad enabled and no caches, each
        pattern group (zamba2's shared block included) is recomputed in
        the backward pass: the reference's ``jax.checkpoint`` of its
        scanned group body; the tail blocks are not."""
        cfg = self.cfg
        period = len(cfg.pattern)
        n_groups = cfg.n_layers // period
        shared = has_shared(cfg)

        def group(g, h):
            aux = 0.0  # a tensor once an MoE block adds its loss
            if shared:
                h = self._apply_shared(
                    h, None if caches is None else caches["shared"][g],
                    q_offset)
            for i in range(g * period, (g + 1) * period):
                h, a = self.layers[i](
                    h, None if caches is None else caches["layers"][i],
                    q_offset)
                aux = aux + a
            return h, aux

        aux = 0.0
        for g in range(n_groups):
            h, a = (remat(group, g, h) if caches is None else group(g, h))
            aux = aux + a
        for i in range(n_groups * period, cfg.n_layers):
            h, a = self.layers[i](
                h, None if caches is None else caches["layers"][i], q_offset)
            aux = aux + a
        if caches is not None:
            caches["len"] += h.shape[1]
        return self.final_norm(h), aux

    def embed_inputs(self, batch: dict) -> torch.Tensor:
        """The batch's (torch or numpy) inputs embedded in the compute
        dtype, on the model's device."""
        cfg, dev = self.cfg, self.device
        ct = cdtype(cfg)
        if self.sharded:
            return self._embed_sharded(batch)

        def get(k):
            return torch.as_tensor(batch[k]).to(dev)

        if cfg.input_kind == "frames":
            h = get("frames").to(ct)
        elif cfg.input_kind == "tokens+image":
            img = get("image_embeds").to(ct) @ cast_weight(self, "img_proj", ct)
            tok = cast_weight(self, "embed", ct)[get("tokens").long()]
            h = torch.cat([img, tok], dim=1)
        else:
            h = cast_weight(self, "embed", ct)[get("tokens").long()]
        return h * scalar(cfg.embed_scale, ct)

    def _embed_sharded(self, batch: dict, text_only: bool = False) -> DTensor:
        """``embed_inputs`` on DTensors, at the layer-boundary layout
        (``text_only``: the decode step's tokens alone)."""
        cfg = self.cfg
        ct = cdtype(cfg)
        batch = self._place_batch(batch)
        if text_only:
            h = parallel.embed_tokens(self, batch["tokens"], ct)
        elif cfg.input_kind == "frames":
            h = batch["frames"].to(ct)
        elif cfg.input_kind == "tokens+image":
            img = parallel.project_image(self, batch["image_embeds"], ct)
            tok = logical_constraint(
                parallel.embed_tokens(self, batch["tokens"], ct),
                "batch", None, None)
            h = torch.cat([img, tok], dim=1)
        else:
            h = parallel.embed_tokens(self, batch["tokens"], ct)
        h = logical_constraint(h, "batch", "seq", "embed")
        return h * scalar(cfg.embed_scale, ct)

    def head_logits(self, h, pos=None, dtype=None, cap=None):
        """``h``'s logits over the vocabulary in ``dtype`` (default: the
        compute dtype), soft capped at ``cap``: of position ``pos`` of
        each row (all positions when None).  On DTensors the vocabulary
        is sharded over ``model``."""
        dtype = dtype or cdtype(self.cfg)
        if isinstance(h, DTensor):
            return parallel.head(self, h, pos, dtype, cap)
        if pos is not None:
            h = h[:, pos]
        return softcap(h.to(dtype) @ self.lm_head_weight(dtype), cap)

    def lm_head_weight(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The (d, V) head: the tied embedding's transpose or ``lm_head``,
        in ``dtype`` if given (``cast_weight``)."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = getattr(self, name) if dtype is None else cast_weight(self, name, dtype)
        return w.T if self.cfg.tie_embeddings else w

    def _logits(self, h, pos: int):
        """Position ``pos``'s head in f32, then the final soft cap."""
        return self.head_logits(h, pos, torch.float32, self.cfg.final_softcap)

    def train_loss(self, batch: dict):
        """Returns (loss, metrics): the masked mean cross-entropy of
        ``batch["labels"][t]`` predicted from the hidden state at ``t``
        (llava: the text tail only), plus, for MoE, ``aux_loss_weight``
        times the load-balance loss.  ``metrics`` holds ``xent`` (and
        ``moe_aux``) as 0-d f32 tensors.  Run it with grad enabled to
        train: the groups and the loss chunks are recomputed in the
        backward pass."""
        cfg, dev = self.cfg, self.device
        ct = cdtype(cfg)
        h = self.embed_inputs(batch)
        h = logical_constraint(h, "batch", "seq", "embed")
        h, aux = self.forward_hidden(h)
        if self.sharded:
            return self._loss_sharded(h, aux, batch)
        labels = torch.as_tensor(batch["labels"]).to(dev)
        mask = batch.get("mask")
        mask = (torch.ones(labels.shape, device=dev) if mask is None
                else torch.as_tensor(mask).to(dev).float())
        if cfg.input_kind == "tokens+image":
            # hidden holds the image positions first; loss on the text tail
            h = h[:, -labels.shape[1]:]
        xe = chunked_xent(h, self.lm_head_weight(ct), labels, mask,
                          final_cap=cfg.final_softcap)
        loss, metrics = xe, {"xent": xe}
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux
            metrics["moe_aux"] = aux
        return loss, metrics

    def _loss_sharded(self, h, aux, batch: dict):
        cfg = self.cfg
        placed = self._place_batch({k: batch[k] for k in ("labels", "mask")
                                    if batch.get(k) is not None})
        labels = placed["labels"]
        mask = placed.get("mask")
        if mask is None:
            mask = torch.ones_like(labels, dtype=torch.float32)
        if cfg.input_kind == "tokens+image":
            h = logical_constraint(h, "batch", None, None)[:, -labels.shape[1]:]
        xe = parallel.chunked_xent(self, h, labels, mask.float(),
                                   final_cap=cfg.final_softcap)
        loss, metrics = xe, {"xent": xe}
        if cfg.moe is not None:
            aux = aux.full_tensor() if isinstance(aux, DTensor) else aux
            loss = loss + cfg.moe.aux_loss_weight * aux
            metrics["moe_aux"] = aux
        return loss, metrics

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """Run the prompt through the model, filling fresh caches.
        Returns (last-position logits (B, V) f32, caches)."""
        h = self.embed_inputs(batch)
        caches = self.init_cache(h.shape[0], max_len)
        h, _ = self.forward_hidden(h, caches, q_offset=0)
        return self._logits(h, -1), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: dict):
        """One serving step: token (B,) -> logits (B, V); the caches
        advance in place (and are returned)."""
        cfg, dev = self.cfg, self.device
        ct = cdtype(cfg)
        if self.sharded:
            tok = token if isinstance(token, DTensor) else torch.as_tensor(token)
            h = self._embed_sharded({"tokens": tok[:, None]}, text_only=True)
        else:
            h = cast_weight(self, "embed", ct)[
                torch.as_tensor(token).to(dev).long()][:, None]
            h = h * scalar(cfg.embed_scale, ct)
        h, _ = self.forward_hidden(h, caches, q_offset=caches["len"])
        return self._logits(h, 0), caches


def clone_cache(caches: dict) -> dict:
    """A deep copy of ``caches`` (every tensor cloned)."""
    if isinstance(caches, dict):
        return {k: clone_cache(v) for k, v in caches.items()}
    if isinstance(caches, list):
        return [clone_cache(v) for v in caches]
    return caches.clone() if isinstance(caches, torch.Tensor) else caches
