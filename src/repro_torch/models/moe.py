"""Mixture-of-Experts FFN (dbrx 16e top-4, mixtral 8e top-2) (port of
``repro.models.moe``).

Dispatch is capacity-based and scatter/gather-shaped: each (token,
choice) takes the next slot of its expert's buffer in the flattened
(token, choice) order, and choices past the capacity are dropped.

On DTensors, under sharding rules with an expert axis, the block runs
as an explicit local region (the reference's ``shard_map``): tokens
stay sharded on the DP axes, and one of two modes splits the experts'
work over the ``model`` axis:

* EP (``E % |model| == 0``): experts sharded; two ``all_to_all``s move
  token slots to their expert's rank and back.  Per-shard capacity
  keeps every buffer O(T_local).
* XP (otherwise, mixtral's 8 experts on a 16-wide axis): every rank
  holds all experts with a ``d_ff`` slice; one sum ``all_reduce`` joins
  the partial down projections.

The collectives are ``distributed._collectives.Collectives`` (staged
through the host for gloo) in autograd form.  Single device: the same
local function runs with every expert resident.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ..distributed._collectives import Collectives
from ..distributed.sharding import P, Region, mesh_sizes, sharding_rules
from . import parallel
from .common import Norm, cast_weight, cdtype, dot_f32, normal_init, param, pdtype


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row, ties to the lower index (as
    ``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _act(cfg, g):
    return F.silu(g) if cfg.act.startswith("silu") else F.gelu(g, approximate="tanh")


class _AllToAll(torch.autograd.Function):
    """``Collectives.all_to_all`` (a permutation of blocks: its own
    adjoint)."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_to_all(g)


class _Sum(torch.autograd.Function):
    """The sum over ``comms``' groups, divided by ``div``, of a value the
    caller then uses the same way on every rank: its gradient is the
    incoming one over ``div`` (the reference's ``psum`` and ``pmean``
    under ``shard_map`` with unchecked replication)."""

    @staticmethod
    def forward(ctx, div, x, *comms):
        ctx.div, ctx.n = div, len(comms)
        for c in comms:
            x = c.all_reduce(x, dist.ReduceOp.SUM)
        return x / div

    @staticmethod
    def backward(ctx, g):
        return (None, g / ctx.div) + (None,) * ctx.n


class _ScaleGrad(torch.autograd.Function):
    """Identity whose gradient is scaled by ``k``."""

    @staticmethod
    def forward(ctx, k, x):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, g * ctx.k


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
        """x: (B, S, d) -> (out, aux_loss).  On DTensors: the sharded
        region (``sharded``)."""
        if isinstance(x, DTensor):
            return self.sharded(x)
        b, s, d = x.shape
        out, aux = self.local_moe(self.norm(x).reshape(b * s, d))
        return out.reshape(b, s, d), aux

    def sharded(self, x: DTensor):
        """The reference's ``moe_apply`` under its rules: the normalized
        tokens laid out ``(dp, seq_spec)`` and the expert weights by mode
        (their ``fsdp`` axis gathered), the local function on this rank's
        blocks, then ``(out at the layer-boundary layout, aux)``; ``aux``
        is averaged over ``(dp, ep)``.  DP axes are dropped when the
        batch does not divide them, and EP splits the sequence only when
        it divides."""
        r = sharding_rules()
        if r is None or r.mesh is None or r.ep_axis is None:
            parallel.rules()  # raises: DTensors need the rules
            raise RuntimeError("sharding rules without an expert axis")
        cfg, mesh = self.cfg, r.mesh
        sizes = mesh_sizes(mesh)
        b, s, d = x.shape
        ep = r.ep_axis
        n_ep = sizes[ep]
        # drop DP axes that do not divide the batch (decode, global_batch=1)
        dp = tuple(r.dp_axes)
        dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
        if dp_size > 1 and b % dp_size != 0:
            dp = ()
        ep_mode = cfg.moe.n_experts % n_ep == 0
        seq_spec = ep if (ep_mode and s % n_ep == 0) else None
        h = self.norm(x)

        reg = Region(mesh, set(dp) | {ep})
        tok = P(dp or None, seq_spec, None)
        hl = reg.enter(h, tok)
        if ep_mode:
            specs = {"w_gate": P(ep), "w_up": P(ep), "w_down": P(ep)}
        else:
            specs = {"w_gate": P(None, None, ep), "w_up": P(None, None, ep),
                     "w_down": P(None, ep, None)}
        w = {k: reg.enter(getattr(self, k), spec) for k, spec in specs.items()}
        w["router"] = reg.enter(self.router, P())
        comm = Collectives(mesh.get_group(ep))
        bl, sl, _ = hl.shape
        with parallel.local_params(self, w):
            out, aux = self.local_moe(
                hl.reshape(bl * sl, d),
                exchange=comm if (ep_mode and n_ep > 1) else None)
        if not ep_mode:
            out = _Sum.apply(1, out, comm)  # join the d_ff partials
        elif seq_spec is None and n_ep > 1:
            # every EP rank routes all the tokens (the output is the same
            # on each): each carries 1/n of the gradient back
            out = _ScaleGrad.apply(1.0 / n_ep, out)
        groups = [Collectives(mesh.get_group(a)) for a in (*dp, ep)
                  if sizes[a] > 1]
        aux = _Sum.apply(dp_size * n_ep if dp else n_ep, aux, *groups)
        out = parallel._boundary(reg.leave(out.reshape(bl, sl, d), tok))
        aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
        return out, aux

    def local_moe(self, x_tokens, exchange: Collectives | None = None):
        """The reference's ``_local_moe`` on this rank's tokens and expert
        weights; with ``exchange`` (EP), the token slots go to their
        experts' ranks and back through two ``all_to_all``s over it."""
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

        if exchange is not None:
            # expert groups scatter to their EP rank; token slots from
            # every peer concatenate along the capacity axis:
            # (e, cap, d) -> (e // n, n * cap, d)
            n = exchange.world
            buf = _AllToAll.apply(exchange, buf)
            buf = buf.reshape(n, e // n, cap, d).transpose(0, 1).reshape(
                e // n, n * cap, d)

        gate = torch.bmm(buf, cast_weight(self, "w_gate", ct))
        up = torch.bmm(buf, cast_weight(self, "w_up", ct))
        out = torch.bmm(_act(cfg, gate) * up, cast_weight(self, "w_down", ct))

        if exchange is not None:
            # inverse: capacity blocks return to their token rank
            out = out.reshape(e // n, n, cap, d).transpose(0, 1).reshape(
                e, cap, d)
            out = _AllToAll.apply(exchange, out)

        # gather back and combine (dropped choices read the zero bucket)
        out = torch.cat([out, out.new_zeros((e, 1, d))], dim=1)
        gathered = out.reshape(e * (cap + 1), d)[flat_idx]
        combined = (gathered.reshape(t, k, d) * top_p.to(ct)[..., None]).sum(1)

        # load-balance aux loss (GShard): E * sum_e f_e * P_e
        frac = F.one_hot(top_e, e).float().mean((0, 1))
        aux = torch.tensor(float(e), device=x_tokens.device) * (
            frac * probs.mean(0)).sum()
        return combined, aux
