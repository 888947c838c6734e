"""RWKV-6 "Finch" mixer: data-dependent per-channel decay linear
attention (arXiv:2404.05892), plus the RWKV channel-mix FFN (port of
``repro.models.rwkv6``).

Time mixing (head-wise, K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

Prefill runs the chunked form (GLA-style, f32, chunk 64): within a
chunk two masked products on decay-rescaled keys and queries; across
chunks the (B, H, K, V) state is carried.  Decode is the O(1)
recurrence.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import Norm, cast_weight, cdtype, normal_init, param, pdtype

CHUNK = 64


def dims(cfg):
    h = cfg.d_model // cfg.rwkv_head_dim
    return h, cfg.rwkv_head_dim


def _token_shift(x, last):
    """x_{t-1} with ``last`` filling t=0. x: (B, S, d), last: (B, 1, d)."""
    return torch.cat([last, x[:, :-1]], dim=1)


def _chunked_wkv(r, k, v, logw, u, s0):
    """r/k/v: (B, S, H, hd) f32; logw: (B, S, H, hd) (< 0); u: (H, hd).
    Returns (y, s_final) with s: (B, H, hd_k, hd_v)."""
    b, s, h, hd = r.shape
    nc = s // CHUNK if s % CHUNK == 0 else 1
    ck = s // nc
    rs = r.reshape(b, nc, ck, h, hd)
    ks_ = k.reshape(b, nc, ck, h, hd)
    vs = v.reshape(b, nc, ck, h, hd)
    lw = logw.reshape(b, nc, ck, h, hd)

    cum = torch.cumsum(lw, dim=2)
    # score_ts = sum_c r_tc k_sc exp(cum_{t-1,c} - cum_{s,c}) for s < t,
    # with q' = r * exp(cum_prev), k' = k * exp(-cum)
    cum_prev = cum - lw
    q_r = rs * torch.exp(cum_prev)
    k_r = ks_ * torch.exp(-cum)
    scores = torch.einsum("bcthd,bcshd->bchts", q_r, k_r)
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=r.device),
                      diagonal=-1)                       # strictly lower
    scores = torch.where(mask[None, None, None], scores, 0.0)
    y_intra = torch.einsum("bchts,bcshd->bcthd", scores, vs)
    # diagonal bonus: y_t += (r_t . (u * k_t)) v_t
    diag = torch.einsum("bcthd,hd,bcthd->bcth", rs, u, ks_)
    y_intra = y_intra + diag[..., None] * vs

    # chunk-final states and the inter-chunk recurrence
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)
    k_end = ks_ * decay_to_end
    states = torch.einsum("bcshk,bcshv->bchkv", k_end, vs)
    chunk_decay = torch.exp(cum[:, :, -1])               # (B, nc, H, hd_k)
    sprev = s0
    s_prevs = []
    for c in range(nc):
        s_prevs.append(sprev)
        sprev = sprev * chunk_decay[:, c, ..., None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                # (B, nc, H, K, V)
    y_inter = torch.einsum("bcthk,bchkv->bcthv", q_r, s_prevs)
    y = (y_intra + y_inter).reshape(b, s, h, hd)
    return y, sprev


class RWKV6(torch.nn.Module):
    def __init__(self, cfg, gen: torch.Generator, device="cpu"):
        super().__init__()
        d = cfg.d_model
        h, hd = dims(cfg)
        r_lora = cfg.rwkv_lora_r
        dt = pdtype(cfg)
        std = 0.02
        lo = std / np.sqrt(2 * cfg.n_layers)
        self.cfg = cfg
        self.norm = Norm(cfg, device)
        self.mix = param(torch.full((5, d), 0.5, dtype=dt, device=device))
        for name, shape, sd in (("w_r", (d, d), std), ("w_k", (d, d), std),
                                ("w_v", (d, d), std), ("w_g", (d, d), std),
                                ("w_o", (d, d), lo)):
            setattr(self, name, param(normal_init(gen, shape, sd, dt, device)))
        # decay lora: w_t = exp(-exp(base + tanh(x W1) W2))
        self.w_decay_base = param(torch.full((d,), -6.0, device=device))
        self.w_decay_1 = param(normal_init(gen, (d, r_lora), std, dt, device))
        self.w_decay_2 = param(normal_init(gen, (r_lora, d), std, dt, device))
        self.u_bonus = param(torch.zeros((h, hd), device=device))
        self.ln_out = torch.nn.Module()
        self.ln_out.scale = param(torch.ones(d, device=device))
        self.ln_out.bias = param(torch.zeros(d, device=device))
        # channel mix
        self.cm_mix = param(torch.full((2, d), 0.5, dtype=dt, device=device))
        self.cm_k = param(normal_init(gen, (d, cfg.d_ff), std, dt, device))
        self.cm_v = param(normal_init(gen, (cfg.d_ff, d), lo, dt, device))
        self.cm_r = param(normal_init(gen, (d, d), std, dt, device))

    def forward(self, x, cache=None):
        """x: (B, S, d); cache: None | {shift_tm, shift_cm, state}, whose
        entries are replaced by the new state.  Returns the time-mix plus
        channel-mix delta."""
        cfg = self.cfg
        b, s, d = x.shape
        h, hd = dims(cfg)
        ct = cdtype(cfg)

        def w(name):
            return cast_weight(self, name, ct)

        # ---- time mix
        res = self.norm(x)
        last_tm = (cache["shift_tm"] if cache is not None
                   else res.new_zeros((b, 1, d)))
        prev = _token_shift(res, last_tm)
        mixes = cast_weight(self, "mix", res.dtype)
        xr, xk, xv, xg, xw = [res * m + prev * (1 - m) for m in mixes]

        r = (xr @ w("w_r")).reshape(b, s, h, hd)
        k = (xk @ w("w_k")).reshape(b, s, h, hd)
        v = (xv @ w("w_v")).reshape(b, s, h, hd)
        g = xg @ w("w_g")

        lora = torch.tanh(xw @ w("w_decay_1")) @ w("w_decay_2")
        logw = -torch.exp(self.w_decay_base + lora.float())  # (B, S, d) < 0
        logw = logw.reshape(b, s, h, hd)

        rf, kf, vf = (t.float() for t in (r, k, v))
        s0 = (cache["state"] if cache is not None
              else torch.zeros((b, h, hd, hd), device=x.device))

        if s == 1:  # decode recurrence
            k0, v0 = kf[:, 0][..., None], vf[:, 0][:, :, None, :]
            kv = k0 * v0
            y = torch.einsum("bhk,bhkv->bhv", rf[:, 0],
                             s0 + self.u_bonus[None, :, :, None] * k0 * v0)
            y = y[:, None].reshape(b, 1, h, hd)
            s_final = s0 * torch.exp(logw[:, 0])[..., None] + kv
        else:
            y, s_final = _chunked_wkv(rf, kf, vf, logw, self.u_bonus, s0)

        y = y.reshape(b, s, d)
        # group norm over heads, approximated with a LayerNorm
        mu = y.mean(-1, keepdim=True)
        var = ((y - mu) ** 2).mean(-1, keepdim=True)
        y = (y - mu) * torch.rsqrt(var + 1e-5)
        y = y * self.ln_out.scale + self.ln_out.bias
        y = (y * F.silu(g.float())).to(ct)
        tm_out = y @ w("w_o")
        x1 = x + tm_out

        # ---- channel mix (the time mix's norm parameters, shared)
        res2 = self.norm(x1)
        last_cm = (cache["shift_cm"] if cache is not None
                   else res2.new_zeros((b, 1, d)))
        prev2 = _token_shift(res2, last_cm)
        cm_mix = cast_weight(self, "cm_mix", res2.dtype)
        mk = res2 * cm_mix[0] + prev2 * (1 - cm_mix[0])
        mr = res2 * cm_mix[1] + prev2 * (1 - cm_mix[1])
        kk = torch.square(F.relu(mk @ w("cm_k")))
        cm = kk @ w("cm_v")
        cm = cm * torch.sigmoid(mr @ w("cm_r"))

        if cache is not None:
            cache["shift_tm"] = res[:, -1:].to(cache["shift_tm"].dtype)
            cache["shift_cm"] = res2[:, -1:].to(cache["shift_cm"].dtype)
            cache["state"] = s_final
        return tm_out + cm


def rwkv6_cache_init(cfg, batch, device="cpu"):
    h, hd = dims(cfg)
    d = cfg.d_model
    return {
        "shift_tm": torch.zeros((batch, 1, d), dtype=torch.bfloat16, device=device),
        "shift_cm": torch.zeros((batch, 1, d), dtype=torch.bfloat16, device=device),
        "state": torch.zeros((batch, h, hd, hd), device=device),
    }
