"""dbrx-132b [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16 experts top-4 (fine-grained)."""
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    pattern=("attn",),
    act="silu_glu",
    moe=MoEConfig(n_experts=16, top_k=4),
    rope_theta=500_000.0,
)

SPEC = ArchSpec(
    config=CONFIG,
    skip_shapes={
        "long_500k": "pure full attention: 500k decode needs sub-quadratic "
                     "attention (DESIGN.md §Arch-applicability)",
    },
)
