"""The local-order fixed point (port of ``repro.core.subbin``).

For every same-bin neighbour pair with original SoS order n < p:

    subbin(p) >= subbin(n) + tie      tie = 1 iff idx(n) > idx(p)

The least solution is the longest-path labelling of a 0/1-weighted DAG,
so it is schedule independent: every schedule gives the same integers.
The schedules differ only in how many sweeps they take, which is what
``n_sweeps`` reports (a diagnostic; it never reaches the container):

- ``jacobi``   : dense synchronous sweeps, one relaxation per sweep.
- ``frontier`` : dense sweeps that also track the active mask (the dense
                 form of the paper's worklist).
- ``blockwise``: the whole-field band solve (``kernels.ops``); its count
                 is the number of global band sweeps.

``method="auto"`` follows the engine's rule: the hand-written kernel on
the accelerator, the dense schedule elsewhere.  On a CUDA tensor it is
``blockwise`` (the band-solve kernel); on a CPU tensor it is ``jacobi``,
as in the reference, which runs ``jacobi`` off the TPU.  The bytes do not
depend on the choice; only ``n_sweeps`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from . import topology
from .quantize import quantize


def _relax_once(sub: torch.Tensor, need: list, ndim: int):
    """One Jacobi sweep. Returns (new_sub, changed_mask)."""
    ties = topology.tie_breaker(ndim)
    new = sub
    for k, off in enumerate(topology.offsets(ndim)):
        cand = topology.shift(sub, off, 0) + int(ties[k])
        new = torch.maximum(new, torch.where(need[k], cand, 0))
    return new, new != sub


def _scatter_active(changed: torch.Tensor, need: list, ndim: int):
    """A point is active if a neighbour it is flagged greater than
    changed in the last sweep."""
    act = torch.zeros_like(changed)
    for k, off in enumerate(topology.offsets(ndim)):
        act |= topology.shift(changed, off, False) & need[k]
    return act


def solve_from_flags(flags: torch.Tensor, subbin_dtype: torch.dtype,
                     max_iters: int, method: str = "jacobi"):
    """Iterate to the least fixed point. Returns (subbins, n_sweeps), the
    sweep count equal to the reference's for the same schedule."""
    ndim = flags.dim()
    need = [((flags >> k) & 1).bool() for k in range(len(topology.offsets(ndim)))]
    sub0 = torch.zeros(flags.shape, dtype=subbin_dtype, device=flags.device)
    if method == "jacobi":
        # prime with one sweep so `changed` starts meaningfully
        sub, ch = _relax_once(sub0, need, ndim)
        it = 1
        while bool(ch.any()) and it < max_iters:
            sub, ch = _relax_once(sub, need, ndim)
            it += 1
        return sub, it
    if method == "frontier":
        sub, ch = _relax_once(sub0, need, ndim)
        active = _scatter_active(ch, need, ndim)
        it = 1
        while bool(active.any()) and it < max_iters:
            new, ch = _relax_once(sub, need, ndim)
            ch = ch & active  # only trust activations (identical result)
            sub = torch.where(active, new, sub)
            active = _scatter_active(ch, need, ndim)
            it += 1
        return sub, it
    raise ValueError(f"unknown solver method {method!r}")


def resolve_method(method: str, device: torch.device) -> str:
    """``auto`` -> ``blockwise`` (the band-solve kernel) on CUDA,
    ``jacobi`` on the CPU; other names pass through."""
    if method == "auto":
        return "blockwise" if device.type == "cuda" else "jacobi"
    return method


def solve_subbins(bins: torch.Tensor, values: torch.Tensor,
                  method: str = "auto", max_iters: int | None = None):
    """Compute flags from (bins, original values) and solve.

    Returns (subbins in the bins' width, n_sweeps).  ``max_iters``
    defaults to the paper's termination bound: a chain cannot exceed the
    point count, and each synchronous sweep advances every unsatisfied
    chain by >= 1.
    """
    method = resolve_method(method, bins.device)
    if method == "blockwise":
        return ops.solve_subbins_blockwise(bins, values)
    flags = topology.order_flags(bins, values)
    if max_iters is None:
        max_iters = int(np.prod(bins.shape)) + 2
    sub_dt = torch.int32 if bins.dtype == torch.int32 else torch.int64
    return solve_from_flags(flags, sub_dt, max_iters, method=method)


def verify_no_violation(bins, values, subbins) -> bool:
    """True iff every same-bin constraint is satisfied (test helper)."""
    flags = topology.order_flags(bins, values)
    ndim = bins.dim()
    ties = topology.tie_breaker(ndim)
    for k, off in enumerate(topology.offsets(ndim)):
        need = ((flags >> k) & 1).bool()
        nsub = topology.shift(subbins, off, 0)
        if not bool(torch.all(~need | (subbins >= nsub + int(ties[k])))):
            return False
    return True


def encode_field(x: torch.Tensor, eps_abs: float, method: str = "auto"):
    """quantize + solve: returns (bins, subbins, n_sweeps)."""
    bins = quantize(x, eps_abs)
    sub, iters = solve_subbins(bins, x, method=method)
    return bins, sub, iters
