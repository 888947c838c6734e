"""The LM serving path as PyTorch modules (port of ``repro.models``).

The 10 assigned architectures, built from ``ModelConfig``: ``Model(cfg,
device=...)`` holds one config's weights and serves through
``prefill`` and ``decode_step``; ``convert`` carries the reference's
parameter pytree and cache layout across.  All math uses explicit
dtypes (bf16 compute, f32 accumulation), op for op as the reference.
The reference's training path (``chunked_xent``, ``train_loss``) and its
sharding rules are not ported yet (ROADMAP.md module queue rows 15b and
15c).
"""
from .config import ModelConfig, MoEConfig, reduced_for_smoke
from .registry import ARCHITECTURES, get_arch

__all__ = ["ARCHITECTURES", "ModelConfig", "MoEConfig", "get_arch",
           "reduced_for_smoke"]
