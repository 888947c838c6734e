"""rwkv6-7b "Finch" [arXiv:2404.05892]: 32L d_model=4096 (attention-free)
d_ff=14336 vocab=65536 — data-dependent per-channel decay. O(1)-state
decode => all shapes including long_500k run."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab=65536,
    pattern=("rwkv6",),
    rwkv_head_dim=64,
    rwkv_lora_r=64,
)

SPEC = ArchSpec(config=CONFIG, skip_shapes={})
