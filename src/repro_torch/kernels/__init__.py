"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

A wrapper takes its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches its kernel (built from ``csrc/`` by
``nvcc`` at first use) or raises.  ``LAUNCHES`` counts kernel launches.
"""
from ._lib import LAUNCHES, build, reset_launches

__all__ = ["LAUNCHES", "build", "reset_launches"]
