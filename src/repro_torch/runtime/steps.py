"""Step functions: train (forward, backward, AdamW), prefill, decode
(port of ``repro.runtime.steps``).

The reference's steps are pure, ``(state, inputs) -> (state,
outputs)``, and jitted with the old state donated.  Here the state is a
``Model`` (its parameters) and the AdamW state dict, and the train step
updates both in place and returns them: the card never holds a second
copy of the weights and moments.  A non-finite loss raises
``FloatingPointError`` before anything is written, so a caller's retry
starts from untouched state, as it does from the reference's unchanged
inputs.  Gradient compression plugs in as the ``grad_transform`` hook
(``distributed.compression.make_error_feedback_compressor``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from ..models.common import cdtype
from ..models.config import ModelConfig
from ..models.model import Model
from ..optim.adamw import adamw_init, adamw_update, decay_mask
from ..optim.schedules import cosine_schedule, wsd_schedule


def make_lr_schedule(cfg: ModelConfig, base_lr=3e-4, warmup=None, total=10_000):
    if warmup is None:
        warmup = max(1, min(200, total // 10))
    if cfg.name.startswith("minicpm"):
        return wsd_schedule(base_lr, warmup, total)
    return cosine_schedule(base_lr, warmup, total)


def make_train_step(cfg: ModelConfig, grad_transform: Callable | None = None,
                    base_lr: float = 3e-4, total_steps: int = 10_000,
                    check_finite: bool = True):
    """Returns step(model, opt_state, batch) -> (model, opt_state, metrics).

    ``batch`` holds numpy arrays or tensors (``SyntheticLMStream``);
    ``metrics`` holds ``loss``, ``xent``, ``grad_norm``, ``lr`` (and
    ``moe_aux``) as detached 0-d tensors.  grad_transform: optional
    ``(grads, opt_state) -> (grads, opt_state)`` hook over the
    ``{name: grad}`` dict; the compressed all-reduce plugs in here.
    ``check_finite=False`` skips the loss check (a dry run on ``meta``
    has no values to check).  A model on DTensors (``launch.shardings``)
    runs under its mesh's sharding rules; its gradients are laid out as
    their parameters before the update.
    """
    schedule = make_lr_schedule(cfg, base_lr, total=total_steps)
    decay: dict = {}

    def step(model: Model, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        if not decay:
            decay.update(decay_mask(params, cfg))
        for p in params.values():
            p.grad = None
        loss, metrics = model.train_loss(batch)
        loss.backward()
        if check_finite and not bool(torch.isfinite(loss)):
            for p in params.values():
                p.grad = None
            raise FloatingPointError(f"non-finite loss {loss.item()}")
        # a parameter the loss does not reach (hubert's token embedding)
        # has a zero gradient, as in the reference's value_and_grad
        grads = {k: (torch.zeros_like(p) if p.grad is None
                     else _as_param(p.grad, p))
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        if grad_transform is not None:
            grads, opt_state = grad_transform(grads, opt_state)
        _, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                                 schedule, decay=decay)
        del grads
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics, "loss": loss.detach()}
        return model, opt_state, metrics

    return step


def _as_param(g, p):
    """A DTensor gradient laid out as its parameter (a pending sum over
    the axes the parameter is replicated on is reduced)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def init_train_state(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """A ``Model`` made from ``seed`` on ``device`` and its AdamW state."""
    model = Model(cfg, seed=seed, device=device)
    return model, adamw_init(dict(model.named_parameters()))


def make_prefill(cfg: ModelConfig, max_len: int):
    def fn(model: Model, batch):
        return model.prefill(batch, max_len)

    return fn


def make_decode_step(cfg: ModelConfig):
    def fn(model: Model, token, caches):
        return model.decode_step(token, caches)

    return fn


def make_encoder_forward(cfg: ModelConfig):
    """hubert 'serving': encoder forward returning frame logits in the
    compute dtype."""

    @torch.no_grad()
    def fn(model: Model, batch):
        h, _ = model.forward_hidden(model.embed_inputs(batch))
        return model.head_logits(h, dtype=cdtype(cfg))

    return fn
