"""Logical-axis sharding: model code names axes, the launcher maps them
to mesh axes (port of ``repro.distributed.sharding``).  Every model stays
mesh-agnostic; with no rules installed every constraint is a no-op.

Logical axes used by the zoo:
  batch      -> DP axes, e.g. ('pod', 'data')
  seq        -> sequence parallelism at layer boundaries ('model')
  seq_noshard-> sequence inside attention/FFN (must be unsharded there)
  heads      -> TP over attention heads ('model')
  ffn        -> TP over FFN hidden ('model')
  embed      -> d_model (unsharded in activations)
  vocab      -> TP over vocabulary ('model')
  experts    -> EP over MoE experts ('model')
  fsdp       -> parameter sharding over the DP axis (ZeRO-3)

A spec (``P``) names, for each tensor dim, a mesh axis, a tuple of mesh
axes (the dim split over each of them, major to minor, as in JAX) or
``None``.  On a ``torch.distributed`` ``DeviceMesh`` a spec becomes one
DTensor placement per mesh dim (``to_placements``).  Specs are computed
on the mesh's ``{axis: size}`` alone, so they need no process group.

``Region`` is the counterpart of ``shard_map``: DTensor inputs are
redistributed to the layouts a local computation needs and handed over
as plain local tensors, and its local results are wrapped back as
DTensors.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim (trailing dims
    unnamed are unsharded)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclass
class ShardingRules:
    mesh: object = None             # a DeviceMesh (or None: no sharding)
    rules: dict = field(default_factory=dict)
    # MoE execution plan (see models/moe.py)
    ep_axis: str | None = None      # mesh axis carrying experts
    dp_axes: tuple = ()             # mesh axes carrying tokens

    def spec(self, *logical_names) -> P:
        return P(*(self.rules.get(n) if n is not None else None
                   for n in logical_names))


def set_sharding_rules(r: ShardingRules | None):
    _state.rules = r


def sharding_rules() -> ShardingRules | None:
    return getattr(_state, "rules", None)


@contextmanager
def use_sharding_rules(r: ShardingRules | None):
    prev = sharding_rules()
    set_sharding_rules(r)
    try:
        yield
    finally:
        set_sharding_rules(prev)


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = mesh_sizes(mesh)
    size = 1
    for n in _axes(entry):
        size *= sizes[n]
    return size


def drop_nondivisible(mesh, spec: P, shape) -> P:
    """Replace spec entries that do not divide the dim with None.

    Keeps model code robust across arch extremes (vocab 122753 is odd;
    decode seq dims are 1; kv heads can be < |model|)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        size = _axis_size(mesh, entry)
        out.append(entry if size > 1 and dim % size == 0 else None)
    return P(*out)


def to_placements(mesh, spec: P, ndim: int) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` or
    its axis names): ``Shard(d)`` on each mesh dim named by tensor dim
    ``d``'s entry, ``Replicate()`` on the rest.  A tuple entry shards its
    dim over several mesh dims, major to minor; DTensor nests them in
    mesh order, so the tuple must list them in that order."""
    names = tuple(mesh if isinstance(mesh, (tuple, list)) else mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    for d, entry in enumerate(entries):
        if entry is None:
            continue
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} must list mesh axes in mesh "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def logical_constraint(x, *logical_names):
    """``x`` redistributed to the installed rules' spec of ``logical_names``
    (the reference's ``with_sharding_constraint``).  ``x`` itself when no
    rules or mesh are installed or when it is a plain tensor (inside a
    local region)."""
    r = sharding_rules()
    if r is None or r.mesh is None or not isinstance(x, DTensor):
        return x
    spec = drop_nondivisible(r.mesh, r.spec(*logical_names), x.shape)
    target = to_placements(r.mesh, spec, x.ndim)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(r.mesh, target)


# ----------------------------------------------------------- local regions

def local_shape(shape, mesh, placements) -> tuple:
    """The local shard's shape (every sharded dim divides evenly)."""
    out = list(shape)
    sizes = list(mesh_sizes(mesh).values())
    for size, p in zip(sizes, placements):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over {size}")
            out[p.dim] //= size
    return tuple(out)


def shard_of(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (a view)."""
    coord = mesh.get_coordinate()
    sizes = list(mesh_sizes(mesh).values())
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            full = full.chunk(sizes[i], dim=p.dim)[coord[i]]
    return full


def place(t: torch.Tensor, mesh, spec: P) -> DTensor:
    """Every rank holds all of ``t``: keep this rank's block of it as a
    DTensor laid out by ``spec`` (no collective)."""
    pl = to_placements(mesh, drop_nondivisible(mesh, spec, t.shape), t.ndim)
    return DTensor.from_local(shard_of(t, mesh, pl).contiguous(), mesh, pl,
                              run_check=False)


class Region:
    """A local computation over ``mesh`` (the counterpart of a
    ``shard_map`` body).  ``split`` names the mesh axes over which the
    ranks do different work: an input replicated over such an axis gets
    a partial gradient there (each rank's local gradient is one term of
    the sum).  Over the other axes the work is the same on every rank."""

    def __init__(self, mesh, split=()):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.split = set(split)

    def placements(self, spec: P, ndim: int) -> tuple:
        return to_placements(self.mesh, spec, ndim)

    def enter(self, x: DTensor, spec: P) -> torch.Tensor:
        """``x`` laid out by ``spec``, as this rank's local tensor."""
        pl = self.placements(spec, x.ndim)
        if tuple(x.placements) != pl:
            x = x.redistribute(self.mesh, pl)
        grad = [Partial() if (p == Replicate() and n in self.split) else p
                for n, p in zip(self.names, pl)]
        return x.to_local(grad_placements=grad)

    def leave(self, t: torch.Tensor, spec: P, partial=(),
              reduce: str = "sum") -> DTensor:
        """A local result as a DTensor laid out by ``spec``, a pending
        ``reduce`` (sum, max) over the mesh axes in ``partial``."""
        pl = list(self.placements(spec, t.ndim))
        for a in partial:
            pl[self.names.index(a)] = Partial(reduce)
        return DTensor.from_local(t, self.mesh, pl, run_check=False)

    def coordinate(self, axis: str) -> int:
        return self.mesh.get_coordinate()[self.names.index(axis)]


class CacheView:
    """A cache leaf (a DTensor) as the local tensor a region writes: its
    own block when its layout is ``spec``'s, else a gathered copy.
    ``commit`` writes the region's result (the tensor written in place,
    or one that replaced it) back into the leaf's block."""

    def __init__(self, leaf: DTensor, mesh, spec: P):
        self.leaf = leaf
        target = to_placements(mesh, spec, leaf.ndim)
        self.direct = tuple(leaf.placements) == target
        self.local = (leaf.to_local() if self.direct
                      else leaf.redistribute(mesh, target).to_local())
        self.target, self.mesh = target, mesh

    def commit(self, t: torch.Tensor) -> None:
        own = self.leaf.to_local()
        if self.direct:
            if t.data_ptr() != own.data_ptr():
                own.copy_(t)
            return
        # the gathered copy is whole over the mesh dims where the leaf is
        # sharded and the region's layout is not: keep this rank's block
        coord = self.mesh.get_coordinate()
        sizes = list(mesh_sizes(self.mesh).values())
        for i, (lp, tp) in enumerate(zip(self.leaf.placements, self.target)):
            if lp == tp:
                continue
            if not (isinstance(lp, Shard) and tp == Replicate()):
                raise ValueError(f"cannot write {tp} back into {lp}")
            t = t.chunk(sizes[i], dim=lp.dim)[coord[i]]
        own.copy_(t)
