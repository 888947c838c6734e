"""LR schedules: cosine (default) and WSD (minicpm's warmup-stable-decay,
arXiv:2404.06395 §4); port of ``repro.optim.schedules``.

A schedule is a plain function of the step, computed in f32 op for op as
the reference: it returns a 0-d f32 CPU tensor.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """f32 cosine, correctly rounded (through f64; torch's f32 cosine on
    the CPU is not, and XLA's differs from both in its last bit)."""
    return torch.cos(x.double()).float()


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(warmup, 1)
        t = (step - warmup) / max(total - warmup, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + _cos(math.pi * t))
        return torch.where(step < warmup, warm, cos).to(F32)

    return lr


def wsd_schedule(base_lr: float, warmup: int, total: int, decay_frac: float = 0.1,
                 floor_frac: float = 0.1):
    """Warmup -> stable plateau -> short exponential-ish decay tail."""
    decay_start = int(total * (1.0 - decay_frac))

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(warmup, 1)
        t = (step - decay_start) / max(total - decay_start, 1)
        t = torch.clamp(t, 0.0, 1.0)
        decay = base_lr * torch.pow(_f32(floor_frac), t)
        out = torch.where(step < warmup, warm,
                          torch.where(step < decay_start, _f32(base_lr), decay))
        return out.to(F32)

    return lr
