"""Distributed compression and the LM's sharding over ``torch.distributed``
(port of ``repro.distributed``): the sharded tile path and gradient
compression (``compression``), and the logical-axis sharding rules
(``sharding``, re-exported as the reference re-exports them).
"""
from .compression import (
    TilePut,
    compress_fields_sharded,
    compressed_pod_psum,
    init_error_feedback,
    make_error_feedback_compressor,
    make_tile_put,
)
from .sharding import (
    ShardingRules,
    logical_constraint,
    set_sharding_rules,
    sharding_rules,
)

__all__ = [
    "ShardingRules",
    "TilePut",
    "compress_fields_sharded",
    "compressed_pod_psum",
    "init_error_feedback",
    "logical_constraint",
    "make_error_feedback_compressor",
    "make_tile_put",
    "set_sharding_rules",
    "sharding_rules",
]
