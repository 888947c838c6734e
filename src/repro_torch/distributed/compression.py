"""Distributed compression (port of ``repro.distributed.compression``):
sharded LOPC tile batches, and gradient compression with error feedback.

Field compression across ranks
------------------------------
The engine's resident tile batches are plain leading-axis arrays.  The
reference shards that axis over a JAX mesh and lets XLA's SPMD
partitioner insert the collectives; the port does it by hand over a
``torch.distributed`` process group.  ``make_tile_put(mesh, axis)``
returns a :class:`TilePut`, the ``put`` hook of ``engine.compress_many``
(and ``temporal.compress_chains``).  With it, every resident batch whose
capacity divides by the group's size is split into contiguous rank
blocks of ``capacity / world`` tiles (a batch that does not divide runs
whole on every rank, with no collective: the reference's replicate
rule).  Each rank uploads only its block of tiles, eps and halo-table
rows; quantize, flags and the bins encode run on the block alone (they
are tile-local).  The halo-round solve keeps a replica of the whole
batch's state on every rank: each round a rank solves the active tiles
it owns, all-gathers the blocks back into the replica and derives the
same moved set, active set, ``local1``/``last_round`` and round count as
every other rank.  The subbin word width is the group's maximum (one
``MAX`` all-reduce), and the raw-size encoded rows of every stream are
gathered before the compaction, so the download and the host
serialization run identically on every rank.

**The SPMD contract:** every rank of the group calls with the same
fields, as every device of a JAX mesh runs the same program; every rank
returns the same blobs, equal byte for byte to the unsharded engine's.
The collectives are chosen by the group's backend
(``distributed._collectives``): NCCL on the device tensors, gloo staged
through host tensors; the kernels run on the executor's device either
way.

Gradient compression: int8 quantization of the gradient
stream with a per-leaf scale, plus an error-feedback accumulator so the
compression noise does not bias convergence (Karimireddy et al.,
arXiv:1901.09847):

* :func:`make_error_feedback_compressor`: a ``grad_transform`` that
  quantizes and dequantizes every gradient leaf, carrying the residual
  in ``opt_state["ef"]`` (pytrees through ``torch.utils._pytree``);
* :func:`compressed_pod_psum`: an int8 all-reduce over a process group
  (the reference's cross-pod mesh axis), the scale combined with
  ``MAX``, the integers summed exactly in int32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from ._collectives import Collectives, ShardBlock

# ----------------------------------------------------- sharded tile path


class TilePut:
    """The ``put`` hook of the sharded tile path over one process group.

    Calling it places a numpy array on the rank's device, as the
    reference's ``put`` places one; the executor asks :meth:`block` which
    rows of a resident batch the rank owns.  ``group``, ``rank`` and
    ``world`` name the group and this rank's place in it.
    """

    def __init__(self, group, device):
        self.group = group
        self.comm = Collectives(group)
        self.rank = self.comm.rank
        self.world = self.comm.world
        self.device = torch.device(device)

    def __call__(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def block(self, capacity: int) -> ShardBlock | None:
        """This rank's block of a batch of ``capacity`` tiles, or ``None``
        when the capacity does not divide by the group's size (the batch
        then runs whole on every rank)."""
        if capacity % self.world:
            return None
        b = capacity // self.world
        return ShardBlock(self.rank * b, (self.rank + 1) * b, capacity,
                          self.comm)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_tile_put(mesh, axis: str = "data", device=None) -> TilePut:
    """``put`` hook for the engine's executor: shard the tile-batch axis
    over ``mesh``'s ``axis`` (a ``torch.distributed.device_mesh.DeviceMesh``).

    ``device`` is where this rank's kernels run; by default the mesh's
    own device type (the current CUDA device for a ``"cuda"`` mesh).
    A gloo mesh of ``"cpu"`` type may still run its kernels on the card:
    pass ``device="cuda"``.  Resident capacities are ``floor * 2**k``
    (``engine.buckets``), so pick a plan whose ``batch_tiles`` is a
    multiple of the axis size to split every batch.
    """
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    group = mesh.get_group(axis)
    return TilePut(group, _mesh_device(mesh) if device is None else device)


def compress_fields_sharded(fields, eb, mesh, axis: str = "data", **kw):
    """``engine.compress_many`` with tile batches sharded across ``axis``.

    Every rank of the axis's group calls it with the same arguments and
    gets the same blobs, byte-identical to the unsharded engine's.
    ``device`` (a keyword of ``compress_many``) defaults to the mesh's
    device type.
    """
    from .. import engine

    put = make_tile_put(mesh, axis, device=kw.get("device"))
    kw.setdefault("device", put.device)
    return engine.compress_many(fields, eb, put=put, **kw)


# ------------------------------------------------- gradient compression

def _quantize_leaf(g: torch.Tensor):
    """Symmetric int8 quantization with per-leaf scale."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params):
    """A zero f32 residual per parameter leaf, on the leaf's device."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def make_error_feedback_compressor():
    """grad_transform(grads, opt_state) -> (grads, opt_state).

    opt_state must contain an "ef" tree (init_error_feedback). Residual
    r = g_in - decode(encode(g_in + r_prev)) is carried forward."""

    def transform(grads, opt_state):
        ef = opt_state["ef"]

        def leaf(g, e):
            corrected = g.to(torch.float32) + e
            q, scale = _quantize_leaf(corrected)
            out = _dequantize_leaf(q, scale)
            return out.to(g.dtype), corrected - out

        g_leaves, spec = pytree.tree_flatten(grads)
        e_leaves = spec.flatten_up_to(ef)
        pairs = [leaf(g, e) for g, e in zip(g_leaves, e_leaves)]
        new_grads = pytree.tree_unflatten([p[0] for p in pairs], spec)
        new_ef = pytree.tree_unflatten([p[1] for p in pairs], spec)
        return new_grads, {**opt_state, "ef": new_ef}

    return transform


def compressed_pod_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8 all-reduce of ``x`` over the process ``group`` (for example
    ``mesh.get_group("pod")``; every rank of it calls): quantize, take
    the largest scale, requantize against it so the integer sum is
    exact, sum int32, dequantize.  ~4x less traffic than an f32 sum at
    <1% relative error per reduction."""
    comm = Collectives(group)
    _, scale = _quantize_leaf(x)
    scale_max = comm.all_reduce(scale, dist.ReduceOp.MAX)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale_max), -127, 127
                    ).to(torch.int8)
    total = comm.all_reduce(q.to(torch.int32), dist.ReduceOp.SUM)
    return total.to(torch.float32) * scale_max
