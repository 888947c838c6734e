"""qwen2.5-3b [hf:Qwen/Qwen2.5 family]: 36L d_model=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936 — GQA with QKV bias, tied embeddings.
(The assignment tags an hf:0.5B source; we implement the dims as given.)"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    pattern=("attn",),
    qkv_bias=True,
    tie_embeddings=True,
    act="silu_glu",
    rope_theta=1_000_000.0,
)

SPEC = ArchSpec(
    config=CONFIG,
    skip_shapes={
        "long_500k": "pure full attention: 500k decode needs sub-quadratic "
                     "attention (DESIGN.md §Arch-applicability)",
    },
)
