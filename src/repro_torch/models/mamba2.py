"""Mamba2 / SSD mixer (zamba2 backbone), chunked-scan formulation (port
of ``repro.models.mamba2``).

Prefill runs the block-matrix "chunked dual" form (Dao & Gu,
arXiv:2405.21060): within a chunk the output is a masked (C B^T)-style
product; across chunks a small recurrent state (B, H, P, N) is carried.
Decode is the O(1) recurrence.

Dims: d_inner = expand * d_model = H * P heads; state N = cfg.ssm_state;
scalar decay A per head; depthwise conv over x/B/C.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import Norm, cast_weight, cdtype, normal_init, param, pdtype

CHUNK = 128


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv1d. xbc: (B, S, C). state: (B, K-1, C)."""
    k = w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out), new_state


def _ssd_chunked(xh, bt, ct_, dt_a, h0):
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs (already dt-scaled), bt/ct_: (B, S, N),
    dt_a: (B, S, H) = dt * A (negative), h0: (B, H, P, N) initial state.
    Returns (y (B, S, H, P), h_final).
    """
    b, s, h, p_ = xh.shape
    n = bt.shape[-1]
    nc = s // CHUNK if s % CHUNK == 0 else 1
    ck = s // nc

    xh = xh.reshape(b, nc, ck, h, p_)
    bt = bt.reshape(b, nc, ck, n)
    ct_ = ct_.reshape(b, nc, ck, n)
    da = dt_a.reshape(b, nc, ck, h)

    cum = torch.cumsum(da, dim=2)                       # (B, nc, ck, H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, t, s, H)
    causal = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=xh.device))
    # mask BEFORE exp: exp of the masked (positive) entries overflows
    seg = torch.where(causal[None, None, :, :, None], seg, -torch.inf)
    l_mat = torch.exp(seg)

    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s L_ts x_s
    cb = torch.einsum("bctn,bcsn->bcts", ct_, bt)
    y_intra = torch.einsum("bcts,bctsh,bcshp->bcthp", cb, l_mat, xh)

    # chunk-final states: sum_s decay(end, s) B_s x_s
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B, nc, ck, H)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", bt, decay_end, xh)

    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B, nc, H)
    hprev = h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)               # (B, nc, H, P, N)

    # inter-chunk contribution: C_t decay(t, start) h_prev
    decay_in = torch.exp(cum)
    y_inter = torch.einsum("bctn,bcth,bchpn->bcthp", ct_, decay_in, h_prevs)
    y = (y_intra + y_inter).reshape(b, s, h, p_)
    return y, hprev


class Mamba2(torch.nn.Module):
    def __init__(self, cfg, gen: torch.Generator, device="cpu"):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, n = dims(cfg)
        conv_ch = d_in + 2 * n  # conv over x, B, C
        dt = pdtype(cfg)
        self.cfg = cfg
        self.norm = Norm(cfg, device)
        # projects to [z, x, B, C, dt]
        self.w_in = param(normal_init(gen, (d, 2 * d_in + 2 * n + h), 0.02, dt,
                                      device))
        self.conv_w = param(normal_init(gen, (cfg.ssm_conv, conv_ch), 0.02, dt,
                                        device))
        self.conv_b = param(torch.zeros(conv_ch, dtype=dt, device=device))
        self.a_log = param(torch.log(torch.linspace(1.0, 16.0, h, device=device)))
        self.d_skip = param(torch.ones(h, device=device))
        self.dt_bias = param(torch.zeros(h, device=device))
        self.out_norm = torch.nn.Module()
        self.out_norm.scale = param(torch.zeros(d_in, dtype=dt, device=device))
        self.w_out = param(normal_init(gen, (d_in, d),
                                       0.02 / np.sqrt(2 * cfg.n_layers), dt,
                                       device))

    def forward(self, x, cache=None):
        """x: (B, S, d). cache: None | {conv, ssm}, whose entries are
        replaced by the new state."""
        cfg = self.cfg
        b, s, _ = x.shape
        d_in, h, p_, n = dims(cfg)
        ct = cdtype(cfg)
        res = self.norm(x)
        proj = res @ cast_weight(self, "w_in", ct)
        z, xbc, dtp = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)

        conv_state = cache["conv"] if cache is not None else None
        xbc, new_conv = _causal_conv(xbc, cast_weight(self, "conv_w", ct),
                                     cast_weight(self, "conv_b", ct), conv_state)
        xs, bt, ct_ = torch.split(xbc, [d_in, n, n], dim=-1)

        dt_ = softplus(dtp.float() + self.dt_bias)       # (B, S, H)
        a = -torch.exp(self.a_log)                       # (H,)
        dt_a = dt_ * a

        xh = xs.reshape(b, s, h, p_).float()
        xh_dt = xh * dt_[..., None]
        h0 = (cache["ssm"] if cache is not None
              else torch.zeros((b, h, p_, n), device=x.device))

        if s == 1:  # decode: pure recurrence
            dec = torch.exp(dt_a[:, 0])                  # (B, H)
            st = torch.einsum("bn,bhp->bhpn", bt[:, 0].float(), xh_dt[:, 0])
            h1 = h0 * dec[:, :, None, None] + st
            y = torch.einsum("bn,bhpn->bhp", ct_[:, 0].float(), h1)[:, None]
            y = y.reshape(b, 1, h, p_)
            h_final = h1
        else:
            y, h_final = _ssd_chunked(xh_dt, bt.float(), ct_.float(), dt_a, h0)

        y = y + xh * self.d_skip[None, None, :, None]
        y = y.reshape(b, s, d_in).to(ct)
        # gated RMSNorm (mamba2's out norm)
        y = y * F.silu(z)
        yf = y.float()
        y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-5)
             * (1.0 + self.out_norm.scale.float())).to(ct)
        out = y @ cast_weight(self, "w_out", ct)
        if cache is not None:
            cache["conv"] = new_conv.to(cache["conv"].dtype)
            cache["ssm"] = h_final
        return out


def mamba2_cache_init(cfg, batch, device="cpu"):
    d_in, h, p_, n = dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, h, p_, n), device=device),
    }
