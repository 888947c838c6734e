"""AdamW over the port's parameters (f32 master weights and moments);
port of ``repro.optim.adamw``.

The reference is functional, ``(grads, state, params) -> (new_params,
new_state)``, and its trainer donates the old buffers to the update.
Here the update writes the parameters and moments in place under
``torch.no_grad``, one leaf at a time, so the card never holds two
copies of them (a functional update of qwen2.5-3b would need 86 GB).
The arithmetic is the reference's in f32: the global gradient norm,
the clip scale, the bias corrections ``1 - b**step`` through f32
``pow``, and ``p - lr * (update + decay)``, each rounded as XLA
compiles it (``apply_update``).

Weight decay applies where the *reference's* leaf has rank >= 2.  The
reference stacks every per-layer leaf of a pattern group over the
groups (``groups/slot{i}``), so a 1-D norm scale or QKV bias inside a
group is 2-D there and decays, while the same leaf in ``tail``,
``shared`` or ``final_norm`` does not.  ``decay_mask`` gives the rule
for the port's parameter names.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

F32 = torch.float32
# elements per update chunk, by device type: on the card large chunks
# keep the launches few (f64 temporaries of 128 MB); on the CPU a chunk
# whose temporaries stay in cache runs ~7x faster (50M elements: 0.21 s
# against 1.41 s on 8 threads)
CHUNK = {"cuda": 1 << 24, "cpu": 1 << 18}


def adamw_init(params: dict) -> dict:
    """Zero moments for a ``{name: tensor}`` dict (``Model``'s
    ``named_parameters``) and a 0-d int32 step counter."""
    return {
        "m": {k: torch.zeros_like(p) for k, p in params.items()},
        "v": {k: torch.zeros_like(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32),
    }


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares.  A DTensor
    leaf's sum is reduced over its mesh (each element counted once,
    whatever its placements); the norm is a plain 0-d tensor."""
    sq = []
    for g in grads.values():
        t = torch.sum(torch.square(g.to(F32)))
        sq.append(t.full_tensor() if isinstance(t, DTensor) else t)
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def decay_mask(names, cfg) -> dict:
    """``{name: bool}``: whether the reference decays the leaf, by the
    rank it has in the reference's layout (a leaf of the grouped layers
    ``layers.{L}``, ``L < n_groups * len(pattern)``, gains the stacked
    group axis)."""
    period = len(cfg.pattern)
    grouped = (cfg.n_layers // period) * period

    def stacked(name: str) -> bool:
        parts = name.split(".")
        return parts[0] == "layers" and int(parts[1]) < grouped

    return {n: stacked(n) for n in names}


def _f32(x: float) -> float:
    """``x`` rounded to f32, as XLA rounds a Python constant."""
    return torch.tensor(x, dtype=F32).item()


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32: the product of two f32 values is
    exact in f64, and the f64 sum rounds to the fused result (a second
    rounding to f32 differs from XLA's fused multiply-add only when the
    f64 sum lies within 2**-29 ulp of an f32 midpoint)."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x for x in (a, b, c))
    return (a * b + c).float()


def clip_scale(gnorm: torch.Tensor, clip_norm: float = 1.0) -> torch.Tensor:
    """``min(1, clip_norm / max(gnorm, 1e-9))`` in f32."""
    return torch.clamp(torch.full_like(gnorm, clip_norm)
                       / torch.clamp(gnorm, min=1e-9), max=1.0).to(F32)


def adamw_update(
    grads: dict,
    state: dict,
    params: dict,
    lr_schedule: Callable,
    *,
    decay: dict | None = None,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
):
    """Update ``params`` (``{name: tensor}``) and ``state`` in place:
    ``apply_update`` of the grads clipped to ``clip_norm`` by their
    global norm, at the schedule's rate for the new step.  Returns
    ``(params, state, {"grad_norm", "lr"})`` (0-d tensors)."""
    step = state["step"] + 1
    lr = lr_schedule(step)
    gnorm = global_norm(grads)
    apply_update(grads, state, params, clip_scale(gnorm, clip_norm), lr,
                 decay=decay, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def apply_update(grads: dict, state: dict, params: dict, scale: torch.Tensor,
                 lr: torch.Tensor, *, decay: dict | None = None,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> None:
    """One AdamW step of every leaf, in place, with the gradients times
    ``scale`` and the learning rate ``lr`` (0-d f32 tensors); advances
    ``state["step"]``.

    ``decay[name]`` is True where the leaf gains a stacked axis in the
    reference's layout (``decay_mask``); a leaf decays iff its rank
    there is >= 2.

    Each leaf's update rounds as XLA compiles the reference's
    expressions on the CPU: ``b1 * m + (1 - b1) * g``, ``b2 * v + (1 -
    b2) * g * g``, ``update + weight_decay * p`` and ``p - lr * (...)``
    are fused multiply-adds (one rounding each), and ``(m / bc1) / d``
    is ``m / (bc1 * d)``.  Large leaves run in chunks of ``CHUNK[device
    type]`` elements, which bounds the temporaries.  DTensor leaves
    (the gradient and moments laid out as their parameter) update their
    local blocks: the update is elementwise.
    """
    decay = decay or {}
    step = state["step"] + 1
    stepf = step.to(F32)
    dev = scale.device
    # 0-d device tensors, not Python scalars: CUDA divides by a host
    # scalar through its reciprocal, which rounds differently
    bc1 = (1.0 - torch.pow(torch.tensor(b1, dtype=F32), stepf)).to(dev)
    bc2 = (1.0 - torch.pow(torch.tensor(b2, dtype=F32), stepf)).to(dev)
    neg_lr = (-lr).to(dev)
    fb1, fb2, fwd = _f32(b1), _f32(b2), _f32(weight_decay)

    with torch.no_grad():
        for name, p in params.items():
            stacked = bool(decay.get(name))
            if isinstance(p, DTensor):
                for t in (grads[name], state["m"][name], state["v"][name]):
                    if tuple(t.placements) != tuple(p.placements):
                        raise ValueError(f"{name}: {t.placements} is not laid "
                                         f"out as its parameter {p.placements}")
            # views: the in-place writes land in the leaves themselves
            flat = [_local(t).view(-1)
                    for t in (p, grads[name], state["m"][name], state["v"][name])]
            chunk = CHUNK.get(p.device.type, CHUNK["cuda"])
            for lo in range(0, max(flat[0].numel(), 1), chunk):
                pc, gc, mc, vc = (t[lo:lo + chunk] for t in flat)
                g = gc.to(F32) * scale
                m2 = _fma(fb1, mc, g * (1 - b1))
                v2 = _fma(fb2, vc, g * (1 - b2) * g)
                del g
                # the square root correctly rounded (torch's f32 sqrt on
                # the CPU is not: an f64 root rounds to the f32 one)
                root = torch.sqrt((v2 / bc2).double()).float()
                update = m2 / (bc1 * (root + eps))
                if p.dim() + int(stacked) >= 2:
                    update = _fma(fwd, pc, update)
                pc.copy_(_fma(neg_lr, update, pc))
                mc.copy_(m2)
                vc.copy_(v2)
    state["step"] = step
