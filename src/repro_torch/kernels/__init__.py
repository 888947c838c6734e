"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

A wrapper takes its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches its kernel (built from ``csrc/`` by
``nvcc`` at first use) or raises.  ``LAUNCHES`` counts kernel launches,
``TRANSFORM_LAUNCHES`` those of the integer encode by word transform.
"""
from ._lib import LAUNCHES, TRANSFORM_LAUNCHES, build, reset_launches

__all__ = ["LAUNCHES", "TRANSFORM_LAUNCHES", "build", "reset_launches"]
