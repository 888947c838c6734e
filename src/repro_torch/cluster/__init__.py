"""Sharded store + multi-worker service federation (port of
``repro.cluster``).

One logical LOPC store, served by N workers: a consistent-hash
:class:`ShardMap` places tile ranges (and replicas) on shards, each
shard is a :class:`ShardWorker` — a real
:class:`~repro_torch.store.LopcStore` directory under a real
:class:`~repro_torch.service.CompressionService` —
and a :class:`Router` scatters writes to owners and gathers region
reads back byte-identical to a single-process store, failing reads over
to replicas when a worker dies.  The wire protocol and placement spec
are normative in docs/cluster.md.

    from repro_torch.cluster import LocalCluster
    with LocalCluster(tmpdir, n_shards=4, n_replicas=2) as cluster:
        cluster.router.write("field", x, 1e-2)
        roi = cluster.router.read_roi("field", (slice(0, 8), slice(4, 20)))

The router and every worker run on one torch device, ``device="cuda"``
by default (``LocalCluster(..., device="cpu")`` runs the kernels' plain
versions); the frames on the wire are the reference's, byte for byte.
"""
from .metrics import ClusterMetrics, ShardHealth
from .placement import (DEFAULT_TILES_PER_RANGE, DEFAULT_VNODES, ShardMap,
                        h64, range_of)
from .router import (ClusterUnavailable, LocalCluster, LocalTransport,
                     ProcessCluster, RemoteError, Router, ShardDown,
                     SocketTransport)
from .worker import ShardWorker
from . import placement, protocol

__all__ = [
    "ClusterMetrics",
    "ClusterUnavailable",
    "DEFAULT_TILES_PER_RANGE",
    "DEFAULT_VNODES",
    "LocalCluster",
    "LocalTransport",
    "ProcessCluster",
    "RemoteError",
    "Router",
    "ShardDown",
    "ShardHealth",
    "ShardMap",
    "ShardWorker",
    "SocketTransport",
    "h64",
    "placement",
    "protocol",
    "range_of",
]
