"""The check that the run never loaded JAX or the JAX package.

Names are compared whole, by the part before the first dot, so the port
(``repro_torch``) is not taken for the JAX package (``repro``).
"""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules) -> list[str]:
    """Forbidden top-level names among the module names ``modules``."""
    return sorted({name.split(".", 1)[0] for name in modules} & FORBIDDEN)
