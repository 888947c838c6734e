"""Temporal residual compression of time-evolving fields (port of
``repro.temporal``).

    from repro_torch import temporal

    blob = temporal.compress_chain(frames, eb=1e-2, keyframe_interval=8)
    all_frames = temporal.decompress_chain(blob)      # (T, *shape)
    frame_5 = temporal.decompress_frame(blob, 5)      # keyframe-bounded
    blob = temporal.compress_chain(frames, 1e-2, device="cpu")

Chains predict each frame's bins from the previous frame's decoded bins,
kept on the device, and store only the bin residual; the subbin
local-order solve still runs on every frame, so every decoded frame
keeps full local order like a snapshot.
"""
from .chain import (
    DEFAULT_KEYFRAME_INTERVAL,
    ChainDecoder,
    ChainStats,
    compress_chain,
    compress_chains,
    decompress_chain,
    decompress_frame,
    encode_appended_frame,
)

__all__ = [
    "DEFAULT_KEYFRAME_INTERVAL",
    "ChainDecoder",
    "ChainStats",
    "compress_chain",
    "compress_chains",
    "decompress_chain",
    "decompress_frame",
    "encode_appended_frame",
]
