"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 — the Mistral-7B
transformer BACKBONE; the anyres vision tower is a STUB per the brief
(input_specs() provides precomputed patch embeddings that a learned
projector maps into the LM space)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    pattern=("attn",),
    act="silu_glu",
    input_kind="tokens+image",
    n_image_tokens=576,        # one anyres tile's worth of patches
    rope_theta=1_000_000.0,
)

SPEC = ArchSpec(
    config=CONFIG,
    skip_shapes={
        "long_500k": "pure full attention: 500k decode needs sub-quadratic "
                     "attention (DESIGN.md §Arch-applicability)",
    },
)
