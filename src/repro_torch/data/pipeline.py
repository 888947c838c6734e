"""Deterministic, checkpointable synthetic LM data pipeline (numpy copy
of ``repro.data.pipeline``; its batches are the reference's, bit for
bit).

The stream is a pure function of (seed, step, shard), so fault-tolerant
resume needs only the step counter from the checkpoint: no iterator
state files, no skew after elastic rescale (each host slices the global
batch by its shard index).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.config import ModelConfig
from ..models.inputs import train_batch_specs


@dataclass
class SyntheticLMStream:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    def batch_at(self, step: int) -> dict:
        """The (host-local slice of the) batch for `step` as numpy arrays.
        Deterministic."""
        assert self.global_batch % self.n_shards == 0
        local = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.shard
        )
        specs = train_batch_specs(self.cfg, local, self.seq_len)
        out = {}
        for k, (shape, _) in specs.items():
            if k in ("tokens", "labels"):
                # learnable structure: every token in a sequence shares a
                # per-sequence residue class mod 7, so a bigram learner
                # drops from ln(V) to ~ln(V/7)
                toks = rng.integers(0, self.cfg.vocab, shape, dtype=np.int64)
                residue = toks[..., :1] % 7
                toks = (toks // 7) * 7 + residue
                out[k] = (toks % self.cfg.vocab).astype(np.int32)
            elif k == "mask":
                out[k] = np.ones(shape, np.float32)
            else:
                out[k] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        if "labels" in out and "tokens" in out:
            # next-token objective: labels are tokens shifted left
            out["labels"] = np.concatenate(
                [out["tokens"][..., 1:], out["tokens"][..., :1]], axis=-1
            )
        return out
