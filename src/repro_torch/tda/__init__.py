"""Topological data analysis of fields (port of ``repro.tda``): the
critical-point census and the topology-adaptive error-bound ladder."""
from .adaptive import ladder_indices
from .critpoints import (
    classify_critical_points,
    critical_point_errors,
    critical_signature,
    local_order_violations,
)

__all__ = [
    "classify_critical_points",
    "critical_point_errors",
    "critical_signature",
    "ladder_indices",
    "local_order_violations",
]
