"""Input specs and dummy batches for the serving cells (port of
``repro.models.inputs``).

Batch specs are plain ``(shape, dtype)`` tuples and the decode token a
``meta`` tensor; ``dummy_batch`` draws the reference's numpy values in
the reference's order, so both packages see the same batch.  Modality frontends are stubs: hubert gets precomputed
frame embeddings, llava precomputed patch embeddings.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    if cfg.input_kind == "frames":
        return {
            "frames": ((batch, seq, cfg.d_model), "bfloat16"),
            "labels": ((batch, seq), "int32"),
            "mask": ((batch, seq), "float32"),
        }
    if cfg.input_kind == "tokens+image":
        txt = seq - cfg.n_image_tokens
        return {
            "tokens": ((batch, txt), "int32"),
            "image_embeds": ((batch, cfg.n_image_tokens, cfg.d_model), "bfloat16"),
            "labels": ((batch, txt), "int32"),
            "mask": ((batch, txt), "float32"),
        }
    return {
        "tokens": ((batch, seq), "int32"),
        "labels": ((batch, seq), "int32"),
        "mask": ((batch, seq), "float32"),
    }


def decode_token_specs(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The decode step's token input: a ``meta`` tensor of its shape and
    dtype (the reference's ``ShapeDtypeStruct``)."""
    return torch.empty((batch,), dtype=torch.int32, device="meta")


def dummy_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0) -> dict:
    """Small real CPU tensors: token ids, ones as the mask, and
    ``N(0, 1) * 0.02`` embeddings rounded to bf16."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, _) in train_batch_specs(cfg, batch, seq).items():
        if k in ("tokens", "labels"):
            out[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab, shape).astype(np.int32))
        elif k == "mask":
            out[k] = torch.ones(shape)
        else:
            out[k] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32) * 0.02
            ).to(torch.bfloat16)
    return out
