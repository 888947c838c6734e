"""Mixture-of-Experts FFN (dbrx 16e top-4, mixtral 8e top-2): the
reference's single-device ``_local_moe`` (port of ``repro.models.moe``).

Dispatch is capacity-based and scatter/gather-shaped: each (token,
choice) takes the next slot of its expert's buffer in the flattened
(token, choice) order, and choices past the capacity are dropped.  The
reference's expert-parallel (EP) and expert-tensor-parallel (XP)
``shard_map`` modes run only under its sharding rules, which the port
does not have yet (ROADMAP.md module queue row 15c).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import Norm, cast_weight, cdtype, dot_f32, normal_init, param, pdtype


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, ties to the lower index (as
    ``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _act(cfg, g):
    return F.silu(g) if cfg.act.startswith("silu") else F.gelu(g, approximate="tanh")


class MoE(torch.nn.Module):
    def __init__(self, cfg, gen: torch.Generator, device="cpu"):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        dt = pdtype(cfg)
        std = 0.02
        self.cfg = cfg
        self.norm = Norm(cfg, device)
        self.router = param(normal_init(gen, (d, e), std, torch.float32, device))
        self.w_gate = param(normal_init(gen, (e, d, ff), std, dt, device))
        self.w_up = param(normal_init(gen, (e, d, ff), std, dt, device))
        self.w_down = param(normal_init(gen, (e, ff, d),
                                        std / np.sqrt(2 * cfg.n_layers), dt,
                                        device))

    def forward(self, x):
        """x: (B, S, d) -> (out, aux_loss)."""
        b, s, d = x.shape
        out, aux = self.local_moe(self.norm(x).reshape(b * s, d))
        return out.reshape(b, s, d), aux

    def local_moe(self, x_tokens):
        cfg = self.cfg
        t, d = x_tokens.shape
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        ct = cdtype(cfg)

        logits = dot_f32(x_tokens, cast_weight(self, "router", ct))
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = top_k(probs, k)                   # (T, k)
        top_p = top_p / top_p.sum(-1, keepdim=True)

        cap = int(np.ceil(t * k * cfg.moe.capacity_factor / e / 8.0)) * 8

        # rank of each (token, choice) within its expert's buffer
        e_flat = top_e.reshape(-1)                        # (T*k,)
        onehot = F.one_hot(e_flat, e)
        pos = torch.cumsum(onehot, dim=0) - 1
        pos_flat = pos.gather(1, e_flat[:, None])[:, 0]
        pos_flat = torch.clamp_max(pos_flat, cap)        # cap: dropped

        # one flat row index per (token, choice); slot `cap` of each
        # expert is the drop bucket
        tok_idx = torch.arange(t, device=x_tokens.device).repeat_interleave(k)
        flat_idx = e_flat * (cap + 1) + pos_flat
        buf = torch.zeros((e * (cap + 1), d), dtype=ct, device=x_tokens.device)
        buf[flat_idx] = x_tokens.to(ct)[tok_idx]
        buf = buf.reshape(e, cap + 1, d)[:, :cap]

        gate = torch.bmm(buf, cast_weight(self, "w_gate", ct))
        up = torch.bmm(buf, cast_weight(self, "w_up", ct))
        out = torch.bmm(_act(cfg, gate) * up, cast_weight(self, "w_down", ct))

        # gather back and combine (dropped choices read the zero bucket)
        out = torch.cat([out, out.new_zeros((e, 1, d))], dim=1)
        gathered = out.reshape(e * (cap + 1), d)[flat_idx]
        combined = (gathered.reshape(t, k, d) * top_p.to(ct)[..., None]).sum(1)

        # load-balance aux loss (GShard): E * sum_e f_e * P_e
        frac = F.one_hot(top_e, e).float().mean((0, 1))
        aux = torch.tensor(float(e), device=x_tokens.device) * (
            frac * probs.mean(0)).sum()
        return combined, aux
