"""The collectives of the sharded tile path, over one process group.

One helper, chosen by the group's backend when it is built and never by
catching an error:

* ``nccl`` runs each collective on the device tensors themselves;
* ``gloo`` stages each collective through host tensors explicitly (a
  copy down, the collective on the CPU, a copy back up), so the kernels
  still run on the card while gloo moves only host memory;
* ``fake`` (a dry run's process group, ``launch.dryrun``) runs each
  collective on the tensors where they are, ``meta`` included, and moves
  nothing.

Gathers and exchanges move raw bytes (a ``uint8`` view of the block), so every dtype
the executor carries travels the same way: neither NCCL nor gloo
reduces or gathers ``int16`` or ``bool`` tensors.  ``COUNTS`` counts the
collectives run and the bytes each rank contributed to them.
"""
from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo", "fake")

COUNTS: Counter = Counter()
_COUNTS_LOCK = threading.Lock()


def _count(kind: str, nbytes: int) -> None:
    with _COUNTS_LOCK:
        COUNTS[kind] += 1
        COUNTS["bytes"] += nbytes


def reset_counts() -> None:
    with _COUNTS_LOCK:
        COUNTS.clear()


class Collectives:
    """Gathers and reductions over ``group``, staged as its backend
    needs."""

    def __init__(self, group):
        self.group = group
        self.backend = str(dist.get_backend(group))
        if self.backend not in BACKENDS:
            raise ValueError(f"unsupported process-group backend "
                             f"{self.backend!r} (want one of {BACKENDS})")
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        # where the backend's buffers live (None: where the tensor is)
        self.device = {"nccl": (torch.device("cuda", torch.cuda.current_device())
                                if self.backend == "nccl" else None),
                       "gloo": torch.device("cpu"), "fake": None}[self.backend]

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.device is None else t.to(self.device)

    def all_gather(self, block: torch.Tensor) -> torch.Tensor:
        """Every rank's ``block`` (one shape and dtype on every rank)
        concatenated along dim 0, in rank order, on ``block``'s device."""
        raw = self._staged(block.contiguous().reshape(-1).view(torch.uint8))
        out = raw.new_empty(self.world * raw.numel())
        dist.all_gather_into_tensor(out, raw, group=self.group)
        _count("all_gather", raw.numel())
        full = out.to(block.device).view(block.dtype)
        return full.reshape((self.world * block.shape[0],)
                            + tuple(block.shape[1:]))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s dim 0 in ``world`` equal blocks exchanged: this rank's
        block ``j`` goes to rank ``j``, and block ``i`` of the result came
        from rank ``i``; on ``t``'s device."""
        raw = self._staged(t.contiguous()).view(torch.uint8)
        out = torch.empty_like(raw)
        dist.all_to_all_single(out, raw, group=self.group)
        _count("all_to_all", raw.numel())
        return out.to(t.device).view(t.dtype)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` reduced over the group with ``op`` (a
        ``dist.ReduceOp``), as a new tensor on ``t``'s device."""
        buf = self._staged(t).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        _count("all_reduce", buf.numel() * buf.element_size())
        return buf.to(t.device)


@dataclass(frozen=True)
class ShardBlock:
    """One rank's contiguous block ``[lo, hi)`` of a resident batch of
    ``capacity`` tiles, with the group's collectives."""

    lo: int
    hi: int
    capacity: int
    comm: Collectives

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows from every rank's block rows."""
        return self.comm.all_gather(block)

    def all_reduce_max(self, value: int) -> int:
        """The largest of every rank's ``value``."""
        t = torch.tensor([value], dtype=torch.int64, device=self.comm.device)
        return int(self.comm.all_reduce(t, dist.ReduceOp.MAX)[0])
