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

The same pass also counts the bytes this rank holds over the step (``LiveBytes``; the port's counterpart of the
reference's ``compiled.memory_analysis()``, which these figures are not
claimed to equal): storages, not tensors, each counted once at its
``untyped_storage().nbytes()`` rounded up to the CUDA caching
allocator's 512-byte block, live from the op that made it until its last
tensor dies (a ``weakref.finalize`` on the storage).  Views and in-place
results share a storage and add nothing; a DTensor counts its local
block.  ``memory_analysis(result)`` returns the reference's keys:

  * ``argument_size_in_bytes``: the storages registered before the step
    (parameters, optimizer state, batch, caches), plus any operand
    storage that no op of the step made (a tensor alive before the step
    that was not registered; counted as live from the start),
  * ``output_size_in_bytes``: the distinct storages of ``result`` (a
    module stands for its parameters and buffers),
  * ``alias_size_in_bytes``: those output storages that are argument
    storages (updates and caches written in place),
  * ``peak_memory_in_bytes``: the highest live total over the step,
    arguments included, read after each op's results exist and before
    its operands can die,
  * ``temp_size_in_bytes``: peak - argument - (output - alias),
  * ``generated_code_size_in_bytes``: ``None`` (eager mode generates no
    code; ``generated_code_reason`` says so).

Tensors a step makes outside the dispatcher (``torch.tensor`` of Python
numbers, ``torch.from_numpy``) appear at their ``lift_fresh`` and count
from there.  Buffers a kernel allocates for itself (cuBLAS workspaces,
a library's scratch) and a process group's own buffers never reach the
dispatcher and are not counted.  Storages on every device count, the
host's included (a device step keeps a few scalars there).
"""
from __future__ import annotations

import threading
import weakref
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
# ops that hand a tensor made outside the dispatcher to it
_LIFT = {"lift_fresh", "lift_fresh_copy"}
# the CUDA caching allocator rounds every block up to this many bytes
ALLOC_ROUND = 512
NO_GENERATED_CODE = "eager PyTorch generates no code: nothing is compiled"


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


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and modules (a
    module's parameters and buffers), DTensors as their local blocks."""
    if isinstance(tree, torch.nn.Module):
        yield from (_local(t) for t in tree.parameters())
        yield from (_local(t) for t in tree.buffers())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield _local(tree)


def _storage(t):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # no storage (a wrapper)
        return None


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


class LiveBytes:
    """The storages one rank holds and their high-water mark (see the
    module docstring).  Frees arrive from whichever thread drops a
    storage's last tensor (on CUDA, autograd's), so updates hold a
    lock."""

    def __init__(self, arguments=()):
        self._lock = threading.RLock()
        self._size: dict[int, int] = {}   # live storage -> rounded bytes
        self._args: set[int] = set()      # live argument storages
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        for t in _tensors(arguments):
            self._add(_storage(t), argument=True)

    def _add(self, st, *, argument: bool = False) -> None:
        """Start counting ``st`` if it is new (an argument is counted as
        live from the start: the peak so far rises with it)."""
        if st is None:
            return
        key = st._cdata
        with self._lock:
            old = self._size.get(key)
            n = _rounded(st.nbytes())
            if old is not None:
                if old != n:  # resized in place
                    self._size[key] = n
                    self.live += n - old
                    self.peak = max(self.peak, self.live)
                return
            self._size[key] = n
            self.live += n
            if argument:
                self._args.add(key)
                self.argument_bytes += n
                self.peak += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key).atexit = False

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._size.pop(key, 0)
            self._args.discard(key)

    def observe(self, func, args, kwargs, out) -> None:
        """Account one op: operand storages no op made are arguments
        (or, under ``lift_fresh``, made just now), result storages that
        are new were allocated by it."""
        lift = func._overloadpacket.__name__ in _LIFT
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor):
                self._add(_storage(_local(t)), argument=not lift)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._add(_storage(_local(t)))

    def analysis(self, result=None) -> dict:
        """The reference's ``memory_analysis`` keys for a step that
        returned ``result``."""
        seen: dict[int, int] = {}
        for t in _tensors(result):
            st = _storage(t)
            if st is not None:
                seen[st._cdata] = _rounded(st.nbytes())
        with self._lock:
            alias = sum(n for k, n in seen.items() if k in self._args)
            peak, arg = self.peak, self.argument_bytes
        out = sum(seen.values())
        return {"argument_size_in_bytes": arg,
                "output_size_in_bytes": out,
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": peak - arg - (out - alias),
                "peak_memory_in_bytes": peak,
                "generated_code_size_in_bytes": None,
                "generated_code_reason": NO_GENERATED_CODE}


class CostCounter(TorchDispatchMode):
    """Counts this rank's FLOPs, HBM bytes and collective bytes while
    active (``with CostCounter() as c: ...``, then ``c.summary()``), and
    the live bytes in the same pass (``c.memory_analysis(result)``);
    ``arguments`` are the tensors, modules and trees the step reads,
    built before it."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = 0.0
        self.collective_counts: Counter = Counter()
        self.memory = LiveBytes(arguments)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.memory.observe(func, args, kwargs, out)
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

    def memory_analysis(self, result=None) -> dict:
        """The live-byte keys (module docstring) of the step that returned
        ``result``."""
        return self.memory.analysis(result)
