"""Architecture registry: --arch <id> resolves here.

Each entry carries the exact published config (see configs/<id>.py),
which shapes it supports, and the skip reasons for unsupported cells
(DESIGN.md §Arch-applicability).  The port's own copy of
``repro.models.registry``; ``get_arch`` imports
``repro_torch.configs.<id>``."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field

from .config import ModelConfig

ARCHITECTURES = [
    "starcoder2-15b",
    "qwen2.5-3b",
    "minicpm-2b",
    "gemma2-27b",
    "dbrx-132b",
    "mixtral-8x22b",
    "zamba2-1.2b",
    "rwkv6-7b",
    "hubert-xlarge",
    "llava-next-mistral-7b",
]

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclass
class ArchSpec:
    config: ModelConfig
    # optional per-shape config overrides (e.g. zamba2 long_500k window)
    shape_overrides: dict = field(default_factory=dict)
    skip_shapes: dict = field(default_factory=dict)  # shape -> reason

    def config_for(self, shape: str) -> ModelConfig:
        ov = self.shape_overrides.get(shape)
        return self.config.scaled(**ov) if ov else self.config

    def runnable_shapes(self):
        return [s for s in SHAPES if s not in self.skip_shapes]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCHITECTURES}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}"
    )
    return mod.SPEC
