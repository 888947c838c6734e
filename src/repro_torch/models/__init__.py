"""The LM path as PyTorch modules (port of ``repro.models``).

The 10 assigned architectures, built from ``ModelConfig``: ``Model(cfg,
device=...)`` holds one config's weights, serves through ``prefill`` and
``decode_step`` and trains through ``train_loss`` (autograd, with the
reference's remat; ``repro_torch.runtime`` holds the train step);
``convert`` carries the reference's parameter pytree, AdamW state and
cache layout across.  All math uses explicit dtypes (bf16 compute, f32
accumulation), op for op as the reference.  On parameters placed as
DTensors by ``repro_torch.launch.shardings`` every layer runs sharded
(``parallel``), under the reference's sharding rules.
"""
from .config import ModelConfig, MoEConfig, reduced_for_smoke
from .registry import ARCHITECTURES, get_arch

__all__ = ["ARCHITECTURES", "ModelConfig", "MoEConfig", "get_arch",
           "reduced_for_smoke"]
