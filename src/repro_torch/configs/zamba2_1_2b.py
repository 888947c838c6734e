"""zamba2-1.2b [arXiv:2411.15242]: 38L d_model=2048 (mamba2 backbone,
ssm_state=64) d_ff=8192 vocab=32000, one shared attention(+MLP) block
invoked every 6 mamba blocks (32H kv=32 in the shared block).

Layout here: 6 scan groups of (shared attn -> 6 mamba) + 2 tail mamba
blocks = 38 mamba layers, 6 shared-attn invocations.  The shared block's
per-invocation LoRA adapters are omitted (weights fully shared) — noted
in DESIGN.md.  long_500k RUNS: mamba state is O(1); the shared attn uses
a 4096 sliding window at 500k (documented adaptation)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    pattern=("mamba2",) * 6,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    act="gelu_glu",
)

SPEC = ArchSpec(
    config=CONFIG,
    shape_overrides={
        # bound the shared-attn KV at 500k via SWA (DESIGN.md adaptation)
        "long_500k": dict(window=4096),
    },
    skip_shapes={},
)
