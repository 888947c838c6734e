"""Shard worker: one store directory + one service, behind the protocol
(port of ``repro.cluster.worker``).

A worker owns one :class:`~repro_torch.store.LopcStore` (its shard of the
logical store — sparse v2 containers holding only the tiles placement
assigned it, plus whole chains for arrays it is a home shard of) and
runs the existing :class:`~repro_torch.service.CompressionService` over it,
so shard-local reads keep the single-process stack end to end:
micro-batch coalescing, the decoded-tile LRU, shared device decode
batches, and the per-worker ``ServiceMetrics`` all behave exactly as in
[service.md](../docs/service.md) — the cluster layer adds routing, not
a second read path.

``handle(op, header, payload)`` is the entire worker surface (the
wire-protocol dispatch); ``serve``/``main`` put it behind a socket for
process deployment, and the in-process ``LocalTransport`` calls it
directly for deterministic tests.

The worker's store and service run on one torch device (``device=``,
default ``"cuda"``): a shard's ``READ_TILES`` decodes with kernel 3 on
the card, its chain appends re-encode there.  Asked for ``cuda`` on a
host without a card it raises; it never carries on on the CPU.
"""
from __future__ import annotations

import argparse
import socket
import sys
import threading
from dataclasses import asdict
from pathlib import Path

import numpy as np

from .. import obs as _obs
from ..engine.plan import CompressionPlan
from ..service import CompressionService, ServiceConfig
from ..store import LopcStore
from ..store.cache import DEFAULT_CACHE_BYTES
from ..store.store import MANIFEST_NAME
from . import protocol as proto


class ShardWorker:
    """One shard: an ``LopcStore`` under a ``CompressionService``."""

    def __init__(self, root, *, plan: CompressionPlan | None = None,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 config: ServiceConfig | None = None, device="cuda"):
        root = Path(root)
        if (root / MANIFEST_NAME).exists():
            self.store = LopcStore.open(root, cache_bytes=cache_bytes,
                                        device=device)
        else:
            self.store = LopcStore.create(root, plan=plan,
                                          cache_bytes=cache_bytes,
                                          device=device)
        self.service = CompressionService(
            config or ServiceConfig(plan=self.store.plan, device=str(device))
        )
        self._handlers = {
            proto.OP_PING: self._ping,
            proto.OP_PUT_SHARD: self._put_shard,
            proto.OP_PUT_CHAIN: self._put_chain,
            proto.OP_APPEND_FRAME: self._append_frame,
            proto.OP_READ_TILES: self._read_tiles,
            proto.OP_READ_FRAME: self._read_frame,
            proto.OP_INFO: self._info,
            proto.OP_EXTRA: self._extra,
            proto.OP_METRICS: self._metrics,
            proto.OP_NAMES: self._names,
            proto.OP_DELETE: self._delete,
        }

    def close(self) -> None:
        self.service.stop()
        self.store.close()

    def __enter__(self) -> "ShardWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- dispatch

    def handle(self, op: int, header: dict,
               payload: bytes) -> tuple[dict, bytes]:
        """One request -> ``(reply_header, reply_payload)`` (raises on
        application errors — the transport turns those into OP_ERROR).

        Tracing: a ``_trace`` header key (router-injected) makes this
        worker's spans children of the router's ``lprc.call`` span; the
        completed spans for the trace piggyback home in the reply header
        under ``_spans``.  Error replies carry no spans (the frame has
        no header slot for them) — the failed attempt's evidence is the
        router-side span plus this worker's ``worker_error`` flight
        dump."""
        try:
            fn = self._handlers[op]
        except KeyError:
            raise ValueError(f"unknown op {op}") from None
        ctx = _obs.extract(header) if _obs.enabled() else None
        if ctx is None:
            return fn(header, payload)
        token = _obs.attach(ctx)
        try:
            with _obs.span("worker." + proto.op_name(op)):
                h, p = fn(header, payload)
        except Exception as e:
            # spans stay in the tracer: a later successful call on this
            # trace piggybacks them; true orphans age out of the ring
            _obs.flight_dump("worker_error", trace_id=ctx.trace_id,
                             op=proto.op_name(op), error=str(e))
            raise
        finally:
            _obs.detach(token)
        spans = _obs.tracer().take(ctx.trace_id)
        if spans:
            h = dict(h)
            h[_obs.trace.SPANS_HEADER_KEY] = [s.as_dict() for s in spans]
        return h, p

    def _ping(self, header, payload):
        return {"ok": True}, b""

    def _put_shard(self, header, payload):
        self.store.put(header["name"], payload)
        return {}, b""

    def _put_chain(self, header, payload):
        self.store.put_chain_raw(header["name"], header["entry"], payload)
        return {}, b""

    def _append_frame(self, header, payload):
        frame = np.frombuffer(payload, np.dtype(header["dtype"])) \
            .reshape([int(d) for d in header["shape"]])
        t = self.store.append_frame(header["name"], frame)
        return {"t": t}, b""

    def _read_tiles(self, header, payload):
        tids = [int(t) for t in header["tile_ids"]]
        tiles = self.service.store_tiles(self.store, header["name"], tids)
        metas, blob = proto.pack_arrays([tiles[t] for t in tids])
        for t, m in zip(tids, metas):
            m["id"] = t
        return {"tiles": metas}, blob

    def _read_frame(self, header, payload):
        v = self.service.store_frame(self.store, header["name"],
                                     int(header["t"]))
        metas, blob = proto.pack_arrays([v])
        return {"array": metas[0]}, blob

    def _info(self, header, payload):
        return {"info": self.store.info(header["name"])}, b""

    def _extra(self, header, payload):
        c, _ = self.store._snapshot_reader(header["name"])  # noqa: SLF001
        tag = int(header["tag"])
        if tag not in c.extra:
            return {"present": False}, b""
        return {"present": True}, c.extra_section(tag)

    def _metrics(self, header, payload):
        return {
            "service": asdict(self.service.metrics()),
            "cache": self.store.cache.stats(),
        }, b""

    def _names(self, header, payload):
        return {"names": self.store.names()}, b""

    def _delete(self, header, payload):
        self.store.delete(header["name"])
        return {}, b""

    # --------------------------------------------------------------- socket

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Start a socket server thread -> (bound_port, stop_callable).

        One thread per connection; every received frame is answered
        with OP_REPLY or, when ``handle`` raised, OP_ERROR carrying the
        exception type and message (worker-side poison isolation: a bad
        request fails its own reply, never the connection)."""
        lsock = socket.create_server((host, port))
        lsock.settimeout(0.2)
        bound_port = lsock.getsockname()[1]
        stop = threading.Event()

        def conn_loop(conn: socket.socket) -> None:
            with conn:
                while not stop.is_set():
                    try:
                        op, seq, header, payload = proto.recv_frame(conn)
                    except (ConnectionError, OSError, ValueError):
                        return
                    try:
                        h, p = self.handle(op, header, payload)
                        proto.send_frame(conn, proto.OP_REPLY, seq, h, p)
                    except Exception as e:  # noqa: BLE001 - into OP_ERROR
                        proto.send_frame(conn, proto.OP_ERROR, seq, {
                            "error": type(e).__name__, "message": str(e),
                        })

        def accept_loop() -> None:
            with lsock:
                while not stop.is_set():
                    try:
                        conn, _ = lsock.accept()
                    except TimeoutError:
                        continue
                    except OSError:
                        return
                    conn.settimeout(None)
                    threading.Thread(target=conn_loop, args=(conn,),
                                     daemon=True).start()

        t = threading.Thread(target=accept_loop, daemon=True,
                             name="lopc-shard-accept")
        t.start()

        def stop_serving() -> None:
            stop.set()
            t.join()

        return bound_port, stop_serving


def main(argv=None) -> int:
    """``python -m repro_torch.cluster.worker --root DIR [--port 0]
    [--device cuda]``.

    Prints ``PORT <n>`` once bound (the process-cluster launcher reads
    it), then serves until killed."""
    ap = argparse.ArgumentParser(description="LOPC cluster shard worker")
    ap.add_argument("--root", required=True, help="shard store directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--tile-shape", default=None,
                    help="comma ints, e.g. 16,16,64 (new stores only)")
    ap.add_argument("--batch-tiles", type=int, default=None)
    ap.add_argument("--cache-bytes", type=int, default=DEFAULT_CACHE_BYTES)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the shard's store and service "
                         "(cuda; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    plan = None
    if args.tile_shape is not None or args.batch_tiles is not None:
        kw = {}
        if args.tile_shape is not None:
            kw["tile_shape"] = tuple(int(d)
                                     for d in args.tile_shape.split(","))
        if args.batch_tiles is not None:
            kw["batch_tiles"] = args.batch_tiles
        plan = CompressionPlan(**kw)
    worker = ShardWorker(args.root, plan=plan, cache_bytes=args.cache_bytes,
                         device=args.device)
    port, stop_serving = worker.serve(args.host, args.port)
    print(f"PORT {port}", flush=True)
    try:
        threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    finally:
        stop_serving()
        worker.close()
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())
