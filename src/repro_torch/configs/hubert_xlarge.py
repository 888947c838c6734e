"""hubert-xlarge [arXiv:2106.07447]: 48L d_model=1280 16H (kv=16)
d_ff=5120 vocab=504 — encoder-only (bidirectional), wav2vec2-style.
The conv feature extractor is a STUB per the brief: input_specs()
provides precomputed 1280-d frame embeddings.  No decode step =>
decode_32k / long_500k are skipped."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ArchSpec

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    pattern=("attn",),
    causal=False,
    encoder_only=True,
    norm="layernorm",
    act="gelu",
    input_kind="frames",
)

SPEC = ArchSpec(
    config=CONFIG,
    skip_shapes={
        "decode_32k": "encoder-only architecture has no decode step",
        "long_500k": "encoder-only architecture has no decode step",
    },
)
