"""Numerical core of the port: float bit maps, quantization, topology,
the container format and the non-finite sidecar."""
