"""Roofline accounting of one rank's program, counted as it runs (the
port's counterpart of ``repro.launch.hlo_parse.analyze``).

The reference compiles its step with XLA and parses the partitioned HLO
text.  The port produces no HLO: ``CostCounter``, a
``TorchDispatchMode``, counts each ATen op this rank dispatches, on any
device (``meta`` included, so a dry run needs no memory):

  * dot FLOPs = 2 * numel(result) * contracted extent (matmuls and
    convolutions, by ``torch.utils.flop_counter``'s formulas),
  * HBM bytes: operand and result bytes of every op that touches memory
    (eager mode has no fusions; views, ``empty`` and the collectives'
    waits are free).  An op on DTensors is counted on their local
    blocks,
  * collective wire bytes by kind and group size g (ring), of the
    result's bytes ``out``:
      all-gather out*(g-1)/g | reduce-scatter out*(g-1) |
      all-reduce 2*out*(g-1)/g | all-to-all out*(g-1)/g,
    and a count of each collective.  Both ``torch.distributed``'s
    functional collectives (DTensor's redistributions) and its c10d ops
    (``distributed._collectives``) are counted.

Everything is per device: the program is one rank's.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# op name (without overload) -> collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
_FREE = {"empty", "empty_like", "empty_strided", "wait_tensor",
         "_wrap_tensor_autograd", "detach", "lift_fresh"}


def ring_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Wire bytes of one collective whose result is ``out_bytes``, over a
    group of ``g`` (ring algorithms)."""
    if g <= 1:
        return 0.0
    ring = (g - 1) / g
    return {"all-gather": out_bytes * ring,
            "reduce-scatter": out_bytes * (g - 1),
            "all-reduce": 2 * out_bytes * ring,
            "all-to-all": out_bytes * ring}[kind]


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, torch.ScriptObject):  # a c10d op's ProcessGroup
            return int(torch.distributed.ProcessGroup.unbox(a).size())
    return 1


def _is_view(func) -> bool:
    schema = func._schema
    return (not schema.is_mutable
            and any(r.alias_info is not None for r in schema.returns))


class CostCounter(TorchDispatchMode):
    """Counts this rank's FLOPs, HBM bytes and collective bytes while
    active (``with CostCounter() as c: ...``, then ``c.summary()``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = 0.0
        self.collective_counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in _FREE or _is_view(func):
            return out
        ins = [_local(t) for t in tree_flatten((args, kwargs))[0]]
        outs = [_local(t) for t in tree_flatten(out)[0]]
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            # a c10d op writes its result into its first tensor argument
            result = (outs if not name.endswith("_")
                      else [t for t in ins if isinstance(t, torch.Tensor)][:1])
            out_b = _bytes(result)
            self.collective_bytes += ring_bytes(kind, out_b,
                                                _group_size(args, kwargs))
            self.collective_counts[kind] += 1
            self.hbm_bytes += 2 * out_b
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            largs, lkwargs = torch.utils._pytree.tree_map(_local, (args, kwargs))
            self.flops += float(flop_registry[packet](
                *largs, **lkwargs, out_val=torch.utils._pytree.tree_map(_local, out)))
        self.hbm_bytes += _bytes(ins) + _bytes(outs)
        return out

    def summary(self) -> dict:
        """The keys of the reference's ``hlo_parse.analyze``."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "collective_counts": {k: int(v) for k, v
                                      in sorted(self.collective_counts.items())}}
