"""Distributed compression over ``torch.distributed`` (port of
``repro.distributed``): the sharded tile path and gradient compression.

The reference's package also re-exports its logical-axis sharding rules
(``sharding.py``), which belong to the LM scaffold's distributed part,
ROADMAP.md module queue row 15c; they are not part of the port yet.
"""
from .compression import (
    TilePut,
    compress_fields_sharded,
    compressed_pod_psum,
    init_error_feedback,
    make_error_feedback_compressor,
    make_tile_put,
)

__all__ = [
    "TilePut",
    "compress_fields_sharded",
    "compressed_pod_psum",
    "init_error_feedback",
    "make_error_feedback_compressor",
    "make_tile_put",
]
