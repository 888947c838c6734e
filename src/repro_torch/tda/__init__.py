"""Topological data analysis of fields (port of ``repro.tda``): the
critical-point census, the topology-adaptive error-bound ladder, and the
quality metrics PSNR and SSIM."""
from .adaptive import ladder_indices
from .critpoints import (
    classify_critical_points,
    critical_point_errors,
    critical_signature,
    local_order_violations,
)
from .quality import psnr, ssim

__all__ = [
    "classify_critical_points",
    "critical_point_errors",
    "critical_signature",
    "ladder_indices",
    "local_order_violations",
    "psnr",
    "ssim",
]
