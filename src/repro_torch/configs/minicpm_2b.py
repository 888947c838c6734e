"""minicpm-2b [arXiv:2404.06395]: 40L d_model=2304 36H (kv=36)
d_ff=5760 vocab=122753 — llama-like arch; WSD schedule (optim/schedules)
and mup-style depth scaling (residual_scale, embed_scale)."""
import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    pattern=("attn",),
    act="silu_glu",
    tie_embeddings=True,
    residual_scale=1.4 / np.sqrt(40),  # depth_scale from the paper
    embed_scale=12.0,                  # MiniCPM input scaling
)

SPEC = ArchSpec(
    config=CONFIG,
    skip_shapes={
        "long_500k": "pure full attention: 500k decode needs sub-quadratic "
                     "attention (DESIGN.md §Arch-applicability)",
    },
)
