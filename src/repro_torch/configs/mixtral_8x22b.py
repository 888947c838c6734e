"""mixtral-8x22b [arXiv:2401.04088]: 56L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=32768, MoE 8 experts top-2, SWA window 4096 (per the
assignment's config; SWA bounds KV so long_500k RUNS for this arch)."""
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    pattern=("attn_local",),   # sliding-window attention everywhere
    window=4096,
    act="silu_glu",
    moe=MoEConfig(n_experts=8, top_k=2),
    rope_theta=1_000_000.0,
)

SPEC = ArchSpec(config=CONFIG, skip_shapes={})
