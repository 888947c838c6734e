"""Unified model configuration covering all 10 assigned architectures
(the port's own copy of ``repro.models.config``: pure Python, so the
port keeps it instead of importing the reference)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

BlockKind = Literal["attn", "attn_local", "mamba2", "rwkv6"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free archs)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads

    # block pattern, repeated to n_layers (e.g. gemma2 local/global,
    # zamba2 mamba-with-shared-attn). len(pattern) must divide n_layers.
    pattern: tuple[BlockKind, ...] = ("attn",)

    # attention details
    rope_theta: float = 10_000.0
    qkv_bias: bool = False               # qwen2.5
    window: int | None = None            # sliding-window size for *_local/swa
    attn_softcap: float | None = None    # gemma2: 50.0
    final_softcap: float | None = None   # gemma2: 30.0
    causal: bool = True                  # hubert: False

    # ffn / norm details
    act: Literal["silu_glu", "gelu_glu", "gelu", "relu"] = "silu_glu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    post_norm: bool = False              # gemma2 extra post-norms
    tie_embeddings: bool = False
    residual_scale: float = 1.0          # minicpm depth-mup scaling
    embed_scale: float = 1.0             # minicpm/gemma embed multiplier

    # MoE (None => dense FFN)
    moe: MoEConfig | None = None

    # SSM (mamba2) details
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 6           # zamba2: shared attn block period

    # rwkv6 details
    rwkv_head_dim: int = 64
    rwkv_lora_r: int = 64

    # modality frontend stub: inputs are precomputed embeddings
    input_kind: Literal["tokens", "frames", "tokens+image"] = "tokens"
    n_image_tokens: int = 576            # llava stub
    encoder_only: bool = False           # hubert

    # serving: int8 KV cache (paper-technique quantization on the
    # decode hot path: 2x cache capacity + ~2x KV read bandwidth)
    kv_quant: bool = False

    # training-time defaults
    dtype: str = "bfloat16"              # compute dtype
    param_dtype: str = "float32"

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def block_kinds(self) -> tuple[BlockKind, ...]:
        """Pattern tiled to n_layers; a non-dividing remainder becomes
        tail blocks (zamba2: 38 = 6x6 groups + 2 tail mamba blocks)."""
        reps = self.n_layers // len(self.pattern)
        tail = self.n_layers % len(self.pattern)
        return self.pattern * reps + self.pattern[:tail]

    @property
    def uses_attention(self) -> bool:
        return any(k.startswith("attn") for k in self.block_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no unwindowed full-attention block."""
        for k in self.block_kinds:
            if k == "attn" and self.window is None:
                return False
        return True

    def scaled(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (brief: small layers,
    few experts, tiny vocab; one pattern period at least)."""
    n_layers = max(len(cfg.pattern), 2 if len(cfg.pattern) == 1 else len(cfg.pattern))
    small = dict(
        n_layers=n_layers if cfg.name != "zamba2-1.2b" else cfg.shared_attn_every,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else None,
        d_ff=128,
        vocab=128,
        window=min(cfg.window, 16) if cfg.window else None,
        ssm_state=16,
        ssm_head_dim=16,
        rwkv_head_dim=16,
        rwkv_lora_r=8,
        n_image_tokens=8,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2))
    return cfg.scaled(**small)
