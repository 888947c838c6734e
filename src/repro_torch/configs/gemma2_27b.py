"""gemma2-27b [arXiv:2408.00118]: 46L d_model=4608 32H (GQA kv=16)
d_ff=36864 vocab=256000 — alternating local(4096)/global attention,
attn logit softcap 50, final softcap 30, GeGLU, pre+post norms,
head_dim=128, tied embeddings, embed scaled by sqrt(d_model)."""
import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256_000,
    pattern=("attn_local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu_glu",
    post_norm=True,
    tie_embeddings=True,
    embed_scale=float(np.sqrt(4608.0)),
)

SPEC = ArchSpec(
    config=CONFIG,
    skip_shapes={
        "long_500k": "global layers are full attention: 500k decode needs "
                     "sub-quadratic attention (DESIGN.md §Arch-applicability)",
    },
)
