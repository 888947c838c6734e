"""Blockwise (flash-style) attention as torch ops (port of
``repro.models.attention``).

A loop over KV blocks carries running (max, sum, weighted-acc): the
reference's online-softmax recurrence, op for op, so the (Sq, Skv)
score matrix of one block is the largest intermediate.  Supports GQA
(query groups share KV heads), causal masking with a KV offset (decode),
sliding windows, logit soft-capping, ring caches (``k_start`` < 0 for
unfilled slots) and int8 KV blocks dequantized inside the loop.

``torch.nn.functional.scaled_dot_product_attention`` is not used: it
has no soft cap and no per-block int8 dequantization.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import dot_f32, scalar, softcap

NEG_INF = -1e30


def blockwise_attention(
    q: torch.Tensor,          # (B, Hq, Sq, D)
    k: torch.Tensor,          # (B, Hkv, Skv, D)
    v: torch.Tensor,          # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    q_offset: int = 0,        # absolute position of q[0] (decode: cache len)
    window: int | None = None,
    cap: float | None = None,
    block_k: int = 1024,
    kv_len: int | None = None,  # valid KV length (decode caches)
    k_start: int = 0,         # absolute position of k[0] (ring caches)
    k_scale: torch.Tensor | None = None,  # (B, Hkv, Skv, 1) f32: int8 scales
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    dev = q.device
    # q is scaled in its own dtype; scores come from the operands' dtype
    # with f32 accumulation
    qg = q.reshape(b, hkv, g * sq, d) * scalar(1.0 / np.sqrt(d), q.dtype)

    if skv % block_k != 0:
        block_k = skv  # small inputs: single block
    n_blocks = skv // block_k

    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for blk in range(n_blocks):
        sl = slice(blk * block_k, (blk + 1) * block_k)
        kc, vc = k[:, :, sl], v[:, :, sl]
        if k_scale is not None:  # int8 KV: dequantize the block
            kc = (kc.float() * k_scale[:, :, sl]).to(qg.dtype)
            vc = (vc.float() * v_scale[:, :, sl]).to(qg.dtype)
        s = dot_f32(qg, kc.transpose(-1, -2)).reshape(b, hkv, g, sq, block_k)
        s = softcap(s, cap)
        k_pos = k_start + blk * block_k + torch.arange(block_k, device=dev)
        mask = (k_pos >= 0)[None, :]  # ring caches: unfilled slots
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        if kv_len is not None:
            mask = mask & (k_pos < kv_len)[None, :]  # absolute valid length
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        scale_old = torch.exp(m - m_new)
        l_sum = l_sum * scale_old + p.sum(-1)
        # p in V's dtype for the PV product (f32 statistics kept)
        pv = dot_f32(p.to(vc.dtype).reshape(b, hkv, g * sq, block_k), vc)
        acc = acc * scale_old[..., None] + pv.reshape(b, hkv, g, sq, d)
        m = m_new
    out = acc / torch.clamp_min(l_sum, 1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)
