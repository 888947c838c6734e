"""starcoder2-15b [arXiv:2402.19173]: 40L d_model=6144 48H (GQA kv=4)
d_ff=24576 vocab=49152 — GQA, RoPE. StarCoder2 uses LayerNorm + biased
QKV and plain-GELU FFN."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="starcoder2-15b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    pattern=("attn",),
    norm="layernorm",
    qkv_bias=True,
    act="gelu",
    rope_theta=100_000.0,
)

SPEC = ArchSpec(
    config=CONFIG,
    skip_shapes={
        "long_500k": "pure full attention: 500k decode needs sub-quadratic "
                     "attention (DESIGN.md §Arch-applicability)",
    },
)
