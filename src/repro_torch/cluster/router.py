"""Cluster router: scatter writes to owners, gather reads, fail over
(port of ``repro.cluster.router``).

The router is the client-facing half of the cluster.  It holds one
:class:`~repro_torch.cluster.placement.ShardMap` and a transport per shard,
and turns store-shaped operations into wire calls:

* ``write(name, x, eb)`` compresses the **whole field once** (tile
  halos couple the subbin solve across tile boundaries, so shards
  cannot compress slabs independently and still reach the global least
  fixed point — see docs/cluster.md), then scatters a *sparse* v2
  container to every owning shard: identical header/geometry, real
  byte sections for that shard's tiles, empty entries elsewhere.  The
  scattered sections are byte-verbatim slices of the single-process
  container, which is what makes cluster reads byte-identical to a
  single ``LopcStore`` by construction.
* ``read_roi(name, region)`` maps the region to tile ids, groups them
  by primary owner, issues ``READ_TILES`` per shard, and reassembles
  through the same ``engine.region_from_tiles`` primitive the store
  uses.  A shard that fails (transport error / timeout) triggers
  failover: the lost tiles regroup onto the next replica in placement
  order, with exponential backoff between rounds, and
  :class:`ClusterMetrics` records the failure and the replica-served
  tiles.
* chains (``write_chain``/``append_frame``/``read_frame``) replicate
  whole on the array's home shards; appends re-encode deterministically
  on every replica (the append-equals-whole-chain byte contract), so
  replicas stay bit-identical without shipping bytes twice.

Writes require **every** owner up (no hinted handoff — a failed write
raises and changes nothing durably on the failed shard); reads only
need one live replica per tile range.

The router compresses on one torch device (``device=``, default
``"cuda"``: kernels 1 and 2 through ``engine.compress_many``, a chain's
residual frames through kernel 2's zigzag); the rigs pass the same
device to every worker, whose ``READ_TILES`` decode with kernel 3.  The
reference's ``Router(mesh=...)`` compresses through its mesh-sharded
tile path; the port's ``distributed`` is ROADMAP.md module queue row 13,
so a mesh raises ``NotImplementedError`` at construction.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from .. import engine as _engine
from .. import obs as _obs
from .. import temporal as _temporal
from ..core import bitstream
from ..core.nonfinite import encode_nonfinite
from ..core.quantize import effective_eps
from ..engine.engine import _not_in_slice
from ..engine.plan import (CompressionPlan, TileLayout, canonical3d_shape,
                           tiles_for_region)
from . import protocol as proto
from .metrics import ClusterMetrics
from .placement import DEFAULT_TILES_PER_RANGE, DEFAULT_VNODES, ShardMap
from .worker import ShardWorker


class ShardDown(RuntimeError):
    """Transport-level failure: the shard did not answer (dead process,
    refused/absent connection, timeout, torn frame).  Reads fail over on
    this; application errors (bad name, corrupt payload) do NOT."""


class ClusterUnavailable(RuntimeError):
    """No replica of some required tile range answered."""


class RemoteError(RuntimeError):
    """A worker answered OP_ERROR: the *request* failed on an otherwise
    healthy shard (poison isolation — no failover, no health change)."""

    def __init__(self, error: str, message: str):
        super().__init__(f"{error}: {message}")
        self.error = error


# ------------------------------------------------------------- transports

class LocalTransport:
    """In-process transport over a :class:`ShardWorker` — deterministic
    tests: ``kill()`` makes every call raise :class:`ShardDown` exactly
    as a dead process would, ``revive()`` restores it."""

    def __init__(self, worker: ShardWorker):
        self.worker = worker
        self._dead = False

    def kill(self) -> None:
        self._dead = True

    def revive(self) -> None:
        self._dead = False

    def call(self, op: int, header: dict, payload: bytes = b"",
             timeout: float | None = None) -> tuple[dict, bytes]:
        if self._dead:
            raise ShardDown("worker killed")
        return self.worker.handle(op, header, payload)

    def close(self) -> None:
        pass


class SocketTransport:
    """One persistent connection to a socket worker (lazy reconnect).

    Any socket failure — connect refused, timeout, torn frame — closes
    the connection and raises :class:`ShardDown`; an OP_ERROR reply
    raises :class:`RemoteError` and keeps the connection.
    """

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.host, self.port, self.timeout = host, int(port), timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._seq = 0

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
        return self._sock

    def _close_unlocked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_unlocked()

    def call(self, op: int, header: dict, payload: bytes = b"",
             timeout: float | None = None) -> tuple[dict, bytes]:
        with self._lock:
            try:
                sock = self._connect()
                sock.settimeout(timeout if timeout is not None
                                else self.timeout)
                self._seq += 1
                proto.send_frame(sock, op, self._seq, header, payload)
                rop, rseq, rheader, rpayload = proto.recv_frame(sock)
            except (OSError, ValueError, ConnectionError) as e:
                self._close_unlocked()
                raise ShardDown(
                    f"{self.host}:{self.port}: {type(e).__name__}: {e}"
                ) from e
            if rseq != self._seq:
                self._close_unlocked()
                raise ShardDown(
                    f"{self.host}:{self.port}: reply seq {rseq} != {self._seq}"
                )
            if rop == proto.OP_ERROR:
                raise RemoteError(rheader.get("error", "Error"),
                                  rheader.get("message", ""))
            return rheader, rpayload


# -------------------------------------------------------------- reassembly

class _MetaContainer:
    """The ``c`` argument ``engine.region_from_tiles`` needs, built from
    a manifest entry instead of a parsed container: a header plus a
    lazy extra-section fetch (the non-finite sidecar rides every shard's
    sparse container, so any holder of the array can serve it)."""

    def __init__(self, header: bitstream.Header, fetch_extra):
        self.header = header
        self._fetch = fetch_extra

    def extra_section(self, tag: int) -> bytes:
        return self._fetch(tag)


def _entry_header(info: dict) -> bitstream.Header:
    return bitstream.Header(
        dtype=np.dtype(info["dtype"]), shape=tuple(info["shape"]),
        eb_mode=info["eb_mode"], eb=info["eb"], eps_abs=info["eps_abs"],
        flags=info["flags"],
    )


def _entry_layout(info: dict) -> TileLayout:
    shape = tuple(info["shape"])
    return TileLayout(shape, canonical3d_shape(shape),
                      tuple(int(t) for t in info["tile_shape"]),
                      tuple(int(g) for g in info["grid"]))


# ------------------------------------------------------------------ router

class Router:
    """Scatter/gather front of a shard cluster (store-shaped API)."""

    def __init__(self, transports, *, plan: CompressionPlan | None = None,
                 n_replicas: int = 2, vnodes: int = DEFAULT_VNODES,
                 tiles_per_range: int = DEFAULT_TILES_PER_RANGE,
                 solver: str = "auto", mesh=None, mesh_axis: str = "data",
                 read_timeout: float = 5.0, backoff: float = 0.05,
                 adaptive_eb: str = "off", device="cuda"):
        if mesh is not None:
            _not_in_slice("Router(mesh=...)", 13, "distributed")
        self.transports = list(transports)
        if not self.transports:
            raise ValueError("a cluster needs at least one shard")
        self.plan = plan or CompressionPlan()
        self.map = ShardMap(len(self.transports), n_replicas, vnodes,
                            tiles_per_range)
        self.solver = solver
        if adaptive_eb not in _engine.ADAPTIVE_EB_MODES:
            raise ValueError(f"unknown adaptive_eb mode {adaptive_eb!r} "
                             f"(expected one of {_engine.ADAPTIVE_EB_MODES})")
        self.adaptive_eb = adaptive_eb
        self.read_timeout = read_timeout
        self.backoff = backoff
        self.metrics = ClusterMetrics(len(self.transports))
        self.device = _engine.resolve_device(device)

    # -------------------------------------------------------------- calling

    def _call(self, shard: int, op: int, header: dict,
              payload: bytes = b"") -> tuple[dict, bytes]:
        """One shard call; ShardDown updates health and re-raises.

        Tracing: each attempt is one ``lprc.call`` span; the trace
        context is injected into the wire header so the worker's spans
        parent here, and a reply's piggybacked ``_spans`` are ingested
        back into this process's tracer — the cross-process tree.  A
        transport failure leaves the span with ``ShardDown`` status and
        a ``shard_down`` flight dump."""
        try:
            with _obs.span("lprc.call", shard=shard,
                           op=proto.op_name(op)) as sp:
                out = self.transports[shard].call(
                    op, _obs.inject(header), payload,
                    timeout=self.read_timeout,
                )
                self.metrics.record_shard_ok(shard)
                h, p = out
                piggy = h.pop(_obs.trace.SPANS_HEADER_KEY, None) \
                    if isinstance(h, dict) else None
                if piggy:
                    _obs.tracer().ingest(piggy)
                    sp.set_tag("worker_spans", len(piggy))
                return h, p
        except ShardDown as e:
            self.metrics.record_shard_failure(shard, e)
            # dumped after the span closed, so the dump's event ring and
            # trace snapshot both hold the ShardDown-status attempt
            ctx = _obs.current()
            _obs.flight_dump(
                "shard_down",
                trace_id=ctx.trace_id if ctx else None,
                shard=shard, op=proto.op_name(op), error=str(e))
            raise

    def _call_home(self, name: str, op: int, header: dict,
                   payload: bytes = b"") -> tuple[dict, bytes]:
        """Read-path call answerable by any home replica, in placement
        order with backoff — the metadata/chain failover path."""
        errors = []
        for i, shard in enumerate(self.map.home(name)):
            if i and self.backoff:
                time.sleep(self.backoff * (2 ** (i - 1)))
            try:
                out = self._call(shard, op, header, payload)
            except ShardDown as e:
                errors.append(f"shard {shard}: {e}")
                continue
            if i:
                self.metrics.record_failover()
            return out
        raise ClusterUnavailable(
            f"no home replica of {name!r} answered: {errors}"
        )

    def _broadcast_home(self, name: str, op: int, header: dict,
                        payload: bytes = b"") -> list[tuple[dict, bytes]]:
        """Write-path call that must land on EVERY home replica."""
        return [self._call(s, op, header, payload)
                for s in self.map.home(name)]

    # --------------------------------------------------------------- writes

    def write(self, name: str, x, eb, mode: str = "noa",
              preserve_order: bool = True) -> int:
        """Compress one field and scatter it -> full-container bytes."""
        x = np.asarray(x)
        with _obs.span("router.write", array=name, nbytes=int(x.nbytes),
                       dtype=str(x.dtype)):
            blob = _engine.compress_many(
                [x], eb, mode, preserve_order, self.solver, self.plan,
                adaptive_eb=self.adaptive_eb, device=self.device,
            )[0]
            self.put(name, blob)
        return len(blob)

    def put(self, name: str, blob: bytes) -> None:
        """Scatter an already-compressed v2 container to its owners."""
        c = bitstream.read_container_v2(blob)
        extra = {tag: c.extra_section(tag) for tag in c.extra}
        placed = False
        with _obs.span("router.scatter", array=name, n_tiles=c.n_tiles,
                       nbytes=len(blob)) as sc:
            n_owners = 0
            for shard in range(len(self.transports)):
                owned = set(self.map.shard_tiles(name, c.n_tiles, shard))
                if not owned:
                    continue
                tiles = [c.tile_payloads(t) if t in owned else (b"", b"")
                         for t in range(c.n_tiles)]
                sblob = bitstream.write_container_v2(
                    c.header, c.tile_shape, c.grid, tiles, extra)
                self._call(shard, proto.OP_PUT_SHARD, {"name": name}, sblob)
                placed = True
                n_owners += 1
            sc.set_tag("n_owners", n_owners)
        assert placed  # n_replicas >= 1 guarantees owners exist
        self.metrics.record_write(len(blob))

    def write_chain(self, name: str, frames, eb, mode: str = "noa",
                    preserve_order: bool = True,
                    keyframe_interval=_temporal.DEFAULT_KEYFRAME_INTERVAL,
                    ) -> int:
        """Compress a chain once, replicate byte-verbatim to the home
        shards -> stored payload bytes (per replica)."""
        frames = list(frames)
        blob = _temporal.compress_chain(
            frames, eb, mode, preserve_order, self.solver, self.plan,
            keyframe_interval, adaptive_eb=self.adaptive_eb,
            device=self.device,
        )
        c = bitstream.read_container_v3(blob)
        # only the frame run goes into the payload file; the chain-wide
        # eb ladder (when present) replicates through the manifest entry
        last_e = c.entries[-1]
        payload = blob[c.data_off : c.data_off + last_e.off + last_e.length]
        ladder = None
        if c.header.flags & bitstream.FLAG_ADAPTIVE_EB:
            ladder = [int(k) for k in c.eb_ladder()]
        last = np.asarray(frames[-1])
        if not np.isfinite(last).all():
            last, _ = encode_nonfinite(last)
        eps_eff = effective_eps(c.header.eps_abs)
        eps_tight = eps_eff * (
            2.0**-bitstream.EB_LADDER_K_MAX if ladder is not None else 1.0)
        last_max_bin = float(np.max(np.abs(last), initial=0.0)) / eps_tight + 4
        entry = {
            "container_version": bitstream.VERSION_CHAIN,
            "dtype": str(np.dtype(c.header.dtype)),
            "shape": list(c.header.shape),
            "eb": c.header.eb,
            "eb_mode": c.header.eb_mode,
            "eps_abs": c.header.eps_abs,
            "flags": c.header.flags,
            "tile_shape": list(c.tile_shape),
            "grid": list(c.grid),
            "keyframe_interval": c.keyframe_interval,
            "last_max_bin": last_max_bin,
            "eb_ladder": ladder,
            "frames": [
                {"kind": e.kind, "flags": e.flags, "off": e.off,
                 "len": e.length, "crc": e.crc}
                for e in c.entries
            ],
        }
        self._broadcast_home(name, proto.OP_PUT_CHAIN,
                             {"name": name, "entry": entry}, payload)
        self.metrics.record_write(len(blob))
        return len(payload)

    def put_chain(self, name: str, entry: dict, payload: bytes) -> None:
        """Replicate an already-encoded chain (manifest entry + payload
        bytes, e.g. lifted from an existing single-process store) to the
        home shards byte-verbatim."""
        self._broadcast_home(name, proto.OP_PUT_CHAIN,
                             {"name": name, "entry": entry}, payload)
        self.metrics.record_write(len(payload))

    def append_frame(self, name: str, frame) -> int:
        """Append one frame on EVERY home replica -> its frame index.

        Each replica re-encodes the frame deterministically (the
        append-equals-whole-chain byte contract), so replicas stay
        bit-identical without shipping encoded bytes."""
        x = np.ascontiguousarray(np.asarray(frame))
        replies = self._broadcast_home(name, proto.OP_APPEND_FRAME, {
            "name": name, "dtype": str(x.dtype), "shape": list(x.shape),
        }, x.tobytes())
        ts = {h["t"] for h, _ in replies}
        if len(ts) != 1:  # pragma: no cover - replicas diverged
            raise ClusterUnavailable(
                f"append_frame({name!r}) diverged across replicas: {ts}"
            )
        self.metrics.record_write(x.nbytes)
        return ts.pop()

    def delete(self, name: str) -> None:
        """Drop ``name`` from every shard (a shard that never held it
        answers with an application error, which is fine)."""
        for shard in range(len(self.transports)):
            try:
                self._call(shard, proto.OP_DELETE, {"name": name})
            except ShardDown:
                raise
            except Exception:  # noqa: BLE001 - shard never held the name
                pass

    # ---------------------------------------------------------------- reads

    def info(self, name: str) -> dict:
        return self._call_home(name, proto.OP_INFO, {"name": name})[0]["info"]

    def names(self) -> list[str]:
        """Union of array names across reachable shards."""
        out: set[str] = set()
        for shard in range(len(self.transports)):
            try:
                h, _ = self._call(shard, proto.OP_NAMES, {})
            except ShardDown:
                continue
            out.update(h["names"])
        return sorted(out)

    def _fetch_extra(self, name: str):
        def fetch(tag: int) -> bytes:
            h, p = self._call_home(name, proto.OP_EXTRA,
                                   {"name": name, "tag": int(tag)})
            if not h["present"]:
                raise KeyError(tag)
            return p
        return fetch

    def _gather_tiles(self, name: str, tile_ids) -> dict[int, np.ndarray]:
        """Fetch decoded tile interiors with per-range failover.

        Round ``r`` asks each missing tile's ``owners[r]``; tiles whose
        shard failed roll into round ``r+1`` against the next replica,
        after exponential backoff.  One dead shard therefore costs one
        extra round for its tiles only — other shards' gathers are
        unaffected."""
        pending = list(dict.fromkeys(int(t) for t in tile_ids))
        out: dict[int, np.ndarray] = {}
        errors: list[str] = []
        with _obs.span("router.gather", array=name,
                       n_tiles=len(pending)) as ga:
            failover_tiles = 0
            rounds = 0
            for r in range(self.map.n_replicas):
                if not pending:
                    break
                rounds = r + 1
                if r and self.backoff:
                    time.sleep(self.backoff * (2 ** (r - 1)))
                groups: dict[int, list[int]] = {}
                for t in pending:
                    groups.setdefault(self.map.owners(name, t)[r],
                                      []).append(t)
                pending = []
                for shard, ts in groups.items():
                    try:
                        h, p = self._call(shard, proto.OP_READ_TILES,
                                          {"name": name, "tile_ids": ts})
                    except ShardDown as e:
                        errors.append(f"shard {shard}: {e}")
                        pending.extend(ts)
                        continue
                    arrays = proto.unpack_arrays(h["tiles"], p)
                    for meta, a in zip(h["tiles"], arrays):
                        out[int(meta["id"])] = a
                    if r:
                        self.metrics.record_failover(len(ts))
                        failover_tiles += len(ts)
            ga.set_tag("rounds", rounds)
            if failover_tiles:
                ga.set_tag("failover_tiles", failover_tiles)
        if pending:
            raise ClusterUnavailable(
                f"tiles {sorted(pending)} of {name!r} unavailable on every "
                f"replica: {errors}"
            )
        return out

    def read_roi(self, name: str, region: tuple) -> np.ndarray:
        """Decode ``region`` of a snapshot — byte-identical to a
        single-process ``LopcStore.read_roi`` over the same write."""
        with _obs.span("router.read", array=name, op="roi"):
            info = self.info(name)
            if info["kind"] != "snapshot":
                raise ValueError(
                    f"{name!r} is a {info['kind']}; read chains with "
                    "read_frame"
                )
            layout = _entry_layout(info)
            region = tuple(region)
            tile_ids = tiles_for_region(layout, region)
            tiles = self._gather_tiles(name, tile_ids)
            self.metrics.record_read(len(tile_ids))
            meta = _MetaContainer(_entry_header(info), self._fetch_extra(name))
            return _engine.region_from_tiles(meta, layout, region, tiles)

    def read(self, name: str) -> np.ndarray:
        """Full read: a snapshot array, or a chain as ``(T, *shape)``."""
        info = self.info(name)
        if info["kind"] == "chain":
            return np.stack([self.read_frame(name, t)
                             for t in range(len(info["frames"]))])
        region = tuple(slice(0, n) for n in info["shape"])
        return self.read_roi(name, region)

    def read_frame(self, name: str, t: int) -> np.ndarray:
        """Random-access chain frame, served by any live home replica."""
        h, p = self._call_home(name, proto.OP_READ_FRAME,
                               {"name": name, "t": int(t)})
        self.metrics.record_read()
        return proto.unpack_arrays([h["array"]], p)[0]

    def n_frames(self, name: str) -> int:
        return len(self.info(name)["frames"])

    # -------------------------------------------------------------- metrics

    def cluster_metrics(self) -> dict:
        """Router counters + shard health + aggregated worker metrics."""
        snaps = []
        for shard in range(len(self.transports)):
            try:
                h, _ = self._call(shard, proto.OP_METRICS, {})
            except ShardDown:
                snaps.append(None)
                continue
            snaps.append(h["service"])
        snap = self.metrics.snapshot()
        snap["workers"] = ClusterMetrics.aggregate(snaps)
        return snap


# ----------------------------------------------------------- cluster rigs

class LocalCluster:
    """N in-process shard workers + a router over ``LocalTransport``s.

    The deterministic rig behind the tests and the gated bench:
    ``kill(i)`` severs shard ``i`` at the transport exactly as a dead
    process would, without subprocess nondeterminism.  Every worker
    still runs its own real ``CompressionService`` and ``LopcStore``
    shard directory, on ``device`` like the router: N service threads
    and the caller's thread share the one card, each launching on its
    current stream.
    """

    def __init__(self, root, n_shards: int, *,
                 plan: CompressionPlan | None = None, n_replicas: int = 2,
                 cache_bytes: int | None = None, device="cuda", **router_kw):
        root = Path(root)
        self.workers: list[ShardWorker] = []
        try:
            for i in range(n_shards):
                kw = {} if cache_bytes is None else \
                    {"cache_bytes": cache_bytes}
                self.workers.append(
                    ShardWorker(root / f"shard{i:02d}", plan=plan,
                                device=device, **kw)
                )
        except Exception:
            self.close()
            raise
        self.transports = [LocalTransport(w) for w in self.workers]
        self.router = Router(self.transports, plan=plan,
                             n_replicas=n_replicas, device=device,
                             **router_kw)

    def kill(self, shard: int) -> None:
        self.transports[shard].kill()

    def revive(self, shard: int) -> None:
        self.transports[shard].revive()

    def close(self) -> None:
        for w in self.workers:
            w.close()
        self.workers = []

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProcessCluster:
    """N subprocess workers (``python -m repro_torch.cluster.worker
    --device <device>``) behind ``SocketTransport``s — the deployment
    shape ``launch/serve.py --cluster`` drives.  ``kill(i)`` SIGKILLs the
    worker process.

    On a CUDA device every worker makes its own context on the card and
    loads the kernel libraries; they are built here once, before any
    worker starts, so the workers find them built instead of each
    starting its own ``nvcc`` jobs."""

    def __init__(self, root, n_shards: int, *,
                 plan: CompressionPlan | None = None, n_replicas: int = 2,
                 cache_bytes: int | None = None, spawn_timeout: float = 120.0,
                 env: dict | None = None, device="cuda", **router_kw):
        root = Path(root)
        plan = plan or CompressionPlan()
        dev = _engine.resolve_device(device)
        if dev.type == "cuda":
            from ..kernels import _lib

            _lib.build()
        self.procs: list[subprocess.Popen] = []
        self.transports: list[SocketTransport] = []
        child_env = dict(os.environ)
        pkg_root = str(Path(__file__).resolve().parents[2])  # .../src
        extra = child_env.get("PYTHONPATH")
        child_env["PYTHONPATH"] = pkg_root + (os.pathsep + extra
                                              if extra else "")
        child_env.update(env or {})
        try:
            for i in range(n_shards):
                cmd = [sys.executable, "-m", "repro_torch.cluster.worker",
                       "--root", str(root / f"shard{i:02d}"), "--port", "0",
                       "--device", str(dev)]
                if plan.tile_shape is not None:
                    cmd += ["--tile-shape",
                            ",".join(str(d) for d in plan.tile_shape)]
                cmd += ["--batch-tiles", str(plan.batch_tiles)]
                if cache_bytes is not None:
                    cmd += ["--cache-bytes", str(cache_bytes)]
                p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     env=child_env, text=True)
                self.procs.append(p)
            for p in self.procs:
                port = self._read_port(p, spawn_timeout)
                self.transports.append(SocketTransport("127.0.0.1", port))
        except Exception:
            self.close()
            raise
        self.router = Router(self.transports, plan=plan,
                             n_replicas=n_replicas, device=dev, **router_kw)

    @staticmethod
    def _read_port(p: subprocess.Popen, timeout: float) -> int:
        deadline = time.monotonic() + timeout
        line = ""
        while time.monotonic() < deadline:
            line = p.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"worker exited before binding (rc={p.poll()})"
                )
            if line.startswith("PORT "):
                return int(line.split()[1])
        raise TimeoutError(f"worker did not bind in {timeout}s ({line!r})")

    def kill(self, shard: int) -> None:
        self.procs[shard].kill()
        self.transports[shard].close()

    def close(self) -> None:
        for t in self.transports:
            t.close()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                p.kill()
                p.wait()
            if p.stdout is not None:
                p.stdout.close()
        self.procs = []
        self.transports = []

    def __enter__(self) -> "ProcessCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
