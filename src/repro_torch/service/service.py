"""Async micro-batching compression service over the engine (port of
``repro.service.service``).

The engine (``engine.compress_many``/``decompress_many``) coalesces any
mix of requests it is *handed in one call* into shared device-resident
tile batches — but something has to hand it concurrent traffic.  This
module is that something: a bounded request queue, a worker thread, and
a deadline/size coalescer that drains whatever concurrent clients have
submitted into micro-batches, so independent requests arriving within a
few milliseconds of each other ride the same device programs.

Dataflow (one worker, clients on any thread or event loop):

  submit            client calls ``submit_compress``/``submit_decompress``/
                    ``submit_roi`` -> a Future; the request enters the
                    bounded queue, or is rejected with
                    :class:`ServiceOverloaded` (backpressure: the queue
                    never grows past ``max_queue``, and the rejection
                    carries a ``retry_after`` estimated from recent
                    batch times)
  coalesce          the worker blocks for the first request, then keeps
                    draining until ``max_delay_ms`` after that request's
                    arrival or ``max_batch_requests``, whichever first —
                    the classic deadline/size micro-batching rule
  execute           the drained batch partitions into engine calls:
                    compress requests group by (mode, preserve_order)
                    into ``compress_many`` calls, chain requests by the
                    same key into ``temporal.compress_chains`` calls
                    (frames at the same time step of concurrent chains
                    share resident batches), decompress requests into
                    one ``decompress_many``, store reads by store into
                    ``LopcStore.read_roi_many`` calls (cache-miss tiles
                    of concurrent readers deduplicate and share decode
                    batches; cache hit/miss/eviction counters feed the
                    metrics), store writes by (store, mode, order) into
                    ``write_many`` (one shared compress + one manifest
                    swap), blob ROI and frame reads run per request;
                    the engine then does its own (tile_shape, dtype,
                    width) device grouping and reports it back through
                    the ``group_cb`` hook
  resolve           each request's Future gets its result; per-request
                    latency (submit -> resolve) feeds the metrics

Everything runs against ONE ``CompressionPlan``, solver and device, so
the executor cache (``engine.executor.default_executor``) is keyed once
and steady-state traffic adds no first-use cost: the port compiles
nothing per shape, and ``engine.device.trace_count`` (the libraries
built or loaded) stays put once the kernels are loaded — tests assert
this.  The worker thread runs the port's engine on ``ServiceConfig.device``
(default ``"cuda"``); a request that fails there resolves its Future
with the error, never a rerun elsewhere.  Store requests run on the
store's own device (``LopcStore(device=...)``).

Byte contract: a request compressed through the service yields the
*exact same container bytes* as a direct ``engine.compress`` call with
the same plan/solver, whatever else it was batched with (the bins
section width is part of the engine's group key, so neighbors cannot
widen it; tested).

The service is thread-based (clients block on Futures; an ``asyncio``
client awaits the same Futures via :meth:`CompressionService.acompress`
etc.) because the execute stage is compute-bound, not IO-bound: one
worker thread runs the engine (torch releases the GIL inside its ops and
copies), and N event-loop tasks would still have to serialize there.
Two services' workers may share one cached ``Executor``; the executor
module docstring says why that is safe.
"""
from __future__ import annotations

import asyncio
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from .. import engine, obs, temporal
from ..engine import device as engine_device
from ..engine import executor as engine_executor
from ..engine.plan import CompressionPlan
from .metrics import MetricsRecorder, ServiceMetrics

_MIN_RETRY_AFTER = 0.002


class ServiceOverloaded(RuntimeError):
    """Backpressure rejection: the bounded queue is full.

    ``retry_after`` (seconds) estimates when capacity frees up, from the
    current depth and the recent mean batch execution time — the value a
    fronting HTTP layer would surface as ``Retry-After``.
    """

    def __init__(self, retry_after: float):
        super().__init__(
            f"compression service queue is full; retry in {retry_after:.3f}s"
        )
        self.retry_after = retry_after


@dataclass(frozen=True)
class ServiceConfig:
    """Service tuning knobs.

    ``plan``/``solver``/``decode_path``/``encode_path``/``adaptive_eb``
    pin the one engine configuration every request shares (the keyed
    program cache); ``max_delay_ms`` is the most a lone request waits
    for company (latency floor under light load);
    ``max_batch_requests`` caps a drained batch (latency ceiling under
    heavy load); ``max_queue`` bounds memory and is the backpressure
    threshold.  ``adaptive_eb="tda"`` routes every compress (snapshot,
    chain, store write) through the topology-adaptive per-tile
    eb-ladder; decode needs no knob — containers are self-describing.
    ``device`` is the torch device the worker runs the engine on
    (``"cuda"``, or ``"cpu"`` for the kernels' plain versions); a CUDA
    device must exist.
    """

    plan: CompressionPlan = field(default_factory=CompressionPlan)
    solver: str = "auto"
    decode_path: str = "auto"
    encode_path: str = "auto"
    adaptive_eb: str = "off"
    device: str = "cuda"
    max_batch_requests: int = 64
    max_delay_ms: float = 2.0
    max_queue: int = 512
    latency_window: int = 4096

    def __post_init__(self):
        if self.decode_path not in ("staged", "fused", "auto"):
            raise ValueError(f"unknown decode path {self.decode_path!r}")
        if self.encode_path not in ("staged", "fused", "auto"):
            raise ValueError(f"unknown encode path {self.encode_path!r}")
        if self.adaptive_eb not in engine.ADAPTIVE_EB_MODES:
            raise ValueError(
                f"unknown adaptive_eb mode {self.adaptive_eb!r} "
                f"(expected one of {engine.ADAPTIVE_EB_MODES})")
        engine.resolve_device(self.device)
        if self.max_batch_requests < 1:
            raise ValueError("max_batch_requests must be >= 1")
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")


class _Pending:
    """One queued request: what to run + the Future to resolve."""

    __slots__ = ("kind", "args", "future", "t_submit", "nbytes", "span")

    def __init__(self, kind: str, args: tuple, nbytes: int):
        self.kind = kind
        self.args = args
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.nbytes = nbytes
        # the request span is born here, on the submitting thread, so it
        # parents to whatever that thread is doing (a worker handling an
        # LPRC op, a client's own root span) and the whole service +
        # engine + executor tree hangs under the caller's trace
        self.span = obs.start_span("service.request", kind=kind,
                                   nbytes=nbytes)


class CompressionService:
    """Micro-batching front of the compression engine.

    Use as a context manager (``with CompressionService() as svc:``) or
    call :meth:`start`/:meth:`stop`.  ``autostart=False`` builds the
    service without its worker (tests use this to inspect queue
    behavior deterministically).
    """

    def __init__(self, config: ServiceConfig | None = None, *,
                 autostart: bool = True):
        self.config = config or ServiceConfig()
        self.metrics_recorder = MetricsRecorder(self.config.latency_window)
        self._queue: queue.Queue[_Pending] = queue.Queue(self.config.max_queue)
        self._stop = threading.Event()
        self._discard = threading.Event()  # stop(drain=False): shed backlog
        self._worker: threading.Thread | None = None
        if autostart:
            self.start()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._discard.clear()
        self._worker = threading.Thread(
            target=self._run, name="lopc-service-worker", daemon=True
        )
        self._worker.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the worker.  ``drain=True`` (default) finishes everything
        already queued first; ``drain=False`` cancels queued requests
        (the batch already executing, if any, still completes)."""
        if not drain:
            self._discard.set()  # worker cancels drained batches from now
        self._stop.set()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        # loop: a submit racing the stop flag may still slip one request
        # into the queue after the first drain
        while True:
            leftovers = self._drain_now()
            if not leftovers:
                break
            if drain:
                self._execute_batch(leftovers)
            else:
                for p in leftovers:
                    p.future.cancel()

    def __enter__(self) -> "CompressionService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- submit

    def submit_compress(self, x, eb, mode: str = "noa",
                        preserve_order: bool = True) -> Future:
        """Queue one field for compression -> Future[bytes]."""
        x = np.asarray(x)
        return self._submit(_Pending(
            "compress", (x, float(eb), mode, bool(preserve_order)), x.nbytes
        ))

    def submit_compress_chain(self, frames, eb, mode: str = "noa",
                              preserve_order: bool = True,
                              keyframe_interval=temporal.DEFAULT_KEYFRAME_INTERVAL,
                              ) -> Future:
        """Queue a frame sequence for chain compression -> Future[bytes].

        Chains in the same micro-batch (same mode/order) share one
        ``temporal.compress_chains`` call, so frames at the same time
        step of concurrent chains ride shared device batches."""
        frames = [np.asarray(f) for f in frames]
        return self._submit(_Pending(
            "chain", (frames, float(eb), mode, bool(preserve_order),
                      keyframe_interval),
            sum(f.nbytes for f in frames),
        ))

    def submit_decompress(self, blob: bytes) -> Future:
        """Queue one container for full decode -> Future[np.ndarray]."""
        return self._submit(_Pending("decompress", (blob,), len(blob)))

    def submit_decompress_chain(self, blob: bytes) -> Future:
        """Queue a v3 chain for full decode -> Future[(T, *shape) array]."""
        return self._submit(_Pending("chain_decompress", (blob,), len(blob)))

    def submit_decompress_frame(self, blob: bytes, t: int) -> Future:
        """Queue a random-access frame decode -> Future[np.ndarray]."""
        return self._submit(_Pending("frame", (blob, int(t)), len(blob)))

    def submit_roi(self, blob: bytes, region: tuple) -> Future:
        """Queue a region-of-interest decode -> Future[np.ndarray]."""
        return self._submit(_Pending("roi", (blob, tuple(region)), len(blob)))

    def submit_store_roi(self, store, name: str, region: tuple) -> Future:
        """Queue a store-backed region read -> Future[np.ndarray].

        Store reads in the same micro-batch share one
        ``LopcStore.read_roi_many`` call: cache-miss tiles of concurrent
        readers deduplicate and decode in shared device batches, and the
        store's decoded-tile cache counters land in the service metrics.
        The store's plan should match the service's (both default to the
        same executor cache either way); the read runs on the store's
        device."""
        return self._submit(_Pending(
            "store_roi", (store, str(name), tuple(region)), 0
        ))

    def submit_store_tiles(self, store, name: str, tile_ids) -> Future:
        """Queue a tile-granular store read -> Future[{tile_id: ndarray}].

        The cluster worker's read path: a shard serves the exact tiles
        the router asked for.  Tile reads in the same micro-batch share
        one ``LopcStore.read_tiles_many`` call — same dedup, cache, and
        shared decode batches as ``submit_store_roi``."""
        return self._submit(_Pending(
            "store_tiles", (store, str(name), tuple(int(t) for t in tile_ids)),
            0,
        ))

    def submit_store_frame(self, store, name: str, t: int) -> Future:
        """Queue a store-backed chain frame read -> Future[np.ndarray]."""
        return self._submit(_Pending(
            "store_frame", (store, str(name), int(t)), 0
        ))

    def submit_store_write(self, store, name: str, x, eb,
                           mode: str = "noa",
                           preserve_order: bool = True) -> Future:
        """Queue a compress-and-persist into a store -> Future[int]
        (stored byte count).  Writes to the same store with one
        (mode, order) signature share a single ``write_many`` call —
        one batched compress, one manifest swap."""
        x = np.asarray(x)
        return self._submit(_Pending(
            "store_write",
            (store, str(name), x, float(eb), mode, bool(preserve_order)),
            x.nbytes,
        ))

    # Blocking conveniences -------------------------------------------------

    def compress(self, x, eb, mode: str = "noa",
                 preserve_order: bool = True) -> bytes:
        return self.submit_compress(x, eb, mode, preserve_order).result()

    def compress_chain(self, frames, eb, mode: str = "noa",
                       preserve_order: bool = True,
                       keyframe_interval=temporal.DEFAULT_KEYFRAME_INTERVAL,
                       ) -> bytes:
        return self.submit_compress_chain(
            frames, eb, mode, preserve_order, keyframe_interval
        ).result()

    def decompress(self, blob: bytes) -> np.ndarray:
        return self.submit_decompress(blob).result()

    def decompress_chain(self, blob: bytes) -> np.ndarray:
        return self.submit_decompress_chain(blob).result()

    def decompress_frame(self, blob: bytes, t: int) -> np.ndarray:
        return self.submit_decompress_frame(blob, t).result()

    def decompress_roi(self, blob: bytes, region: tuple) -> np.ndarray:
        return self.submit_roi(blob, region).result()

    def store_roi(self, store, name: str, region: tuple) -> np.ndarray:
        return self.submit_store_roi(store, name, region).result()

    def store_tiles(self, store, name: str, tile_ids) -> dict:
        return self.submit_store_tiles(store, name, tile_ids).result()

    def store_frame(self, store, name: str, t: int) -> np.ndarray:
        return self.submit_store_frame(store, name, t).result()

    def store_write(self, store, name: str, x, eb, mode: str = "noa",
                    preserve_order: bool = True) -> int:
        return self.submit_store_write(store, name, x, eb, mode,
                                       preserve_order).result()

    # Asyncio conveniences --------------------------------------------------

    async def acompress(self, x, eb, mode: str = "noa",
                        preserve_order: bool = True) -> bytes:
        return await asyncio.wrap_future(
            self.submit_compress(x, eb, mode, preserve_order)
        )

    async def acompress_chain(self, frames, eb, mode: str = "noa",
                              preserve_order: bool = True,
                              keyframe_interval=temporal.DEFAULT_KEYFRAME_INTERVAL,
                              ) -> bytes:
        return await asyncio.wrap_future(self.submit_compress_chain(
            frames, eb, mode, preserve_order, keyframe_interval
        ))

    async def adecompress(self, blob: bytes) -> np.ndarray:
        return await asyncio.wrap_future(self.submit_decompress(blob))

    async def adecompress_chain(self, blob: bytes) -> np.ndarray:
        return await asyncio.wrap_future(self.submit_decompress_chain(blob))

    async def adecompress_frame(self, blob: bytes, t: int) -> np.ndarray:
        return await asyncio.wrap_future(self.submit_decompress_frame(blob, t))

    async def adecompress_roi(self, blob: bytes, region: tuple) -> np.ndarray:
        return await asyncio.wrap_future(self.submit_roi(blob, region))

    async def astore_roi(self, store, name: str, region: tuple) -> np.ndarray:
        return await asyncio.wrap_future(
            self.submit_store_roi(store, name, region)
        )

    # -------------------------------------------------------------- metrics

    def metrics(self) -> ServiceMetrics:
        return self.metrics_recorder.snapshot(self._queue.qsize())

    def retry_after(self) -> float:
        """Seconds until queued work likely drains one batch's worth."""
        batches_ahead = max(
            1, -(-self._queue.qsize() // self.config.max_batch_requests)
        )
        est = batches_ahead * self.metrics_recorder.mean_batch_seconds()
        return max(_MIN_RETRY_AFTER, est)

    # ------------------------------------------------------------- internals

    def _submit(self, p: _Pending) -> Future:
        if self._stop.is_set():
            # after stop() nothing will ever drain the queue — fail loud
            # instead of returning a Future that can never resolve
            # (autostart=False services haven't stopped: their queue is
            # drained by the eventual start())
            err = RuntimeError("compression service is stopped")
            obs.finish_span(p.span, error=err)
            raise err
        try:
            self._queue.put_nowait(p)
        except queue.Full:
            self.metrics_recorder.record_reject()
            err = ServiceOverloaded(self.retry_after())
            obs.finish_span(p.span, error=err)
            raise err from None
        if self._stop.is_set() and self._worker is None:
            # raced a concurrent stop(): its drain loop may already have
            # seen an empty queue, so finish the straggler here on the
            # submitting thread rather than strand its Future
            leftovers = self._drain_now()
            if leftovers:
                self._execute_batch(leftovers)
        self.metrics_recorder.record_submit(p.kind)
        return p.future

    def _drain_now(self) -> list[_Pending]:
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    def _run(self) -> None:
        cfg = self.config
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            # greedy pass: whatever already queued up while the previous
            # batch executed joins immediately (the backlog case — the
            # deadline below may be long expired for these)
            while len(batch) < cfg.max_batch_requests:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            # deadline pass: wait out the rest of the oldest request's
            # delay budget for stragglers (the light-load case)
            deadline = first.t_submit + cfg.max_delay_ms / 1e3
            while len(batch) < cfg.max_batch_requests:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=timeout))
                except queue.Empty:
                    break
            if self._discard.is_set():  # stop(drain=False): shed backlog
                for p in batch:
                    p.future.cancel()
                continue
            try:
                self._execute_batch(batch)
            except BaseException as e:  # noqa: BLE001 - worker must survive
                # _execute_batch isolates request errors into Futures;
                # anything escaping is a harness bug — fail the batch's
                # still-pending Futures rather than dying silently
                for p in batch:
                    if not p.future.done():
                        try:
                            p.future.set_exception(e)
                        except Exception:  # noqa: BLE001, S110
                            pass

    def _execute_batch(self, batch: list[_Pending]) -> None:
        """Run one drained micro-batch through the engine."""
        # claim every Future up front: a client that cancelled while its
        # request was queued simply drops out of the batch (and can no
        # longer cancel once we are running), so a cancellation can
        # never wedge the worker or its batch-mates
        batch = [p for p in batch
                 if p.future.set_running_or_notify_cancel()]
        if not batch:
            return
        rec = self.metrics_recorder
        t0 = time.monotonic()
        if obs.enabled():
            for p in batch:
                p.span.set_tag("queue_ms",
                               round((t0 - p.t_submit) * 1e3, 3))
        tc0 = dict(engine_executor.TRANSFER_COUNTS)
        tr0 = engine_device.trace_count()

        # compress requests sharing (mode, preserve_order) share one
        # compress_many call, chain requests one compress_chains call
        # (frames of concurrent chains share resident step batches),
        # store reads share one read_roi_many per store and store writes
        # one write_many per (store, mode, order); the engine sub-groups
        # by device signature
        comp_groups: dict[tuple, list[_Pending]] = {}
        chain_groups: dict[tuple, list[_Pending]] = {}
        sroi_groups: dict[int, list[_Pending]] = {}    # keyed id(store)
        stile_groups: dict[int, list[_Pending]] = {}   # keyed id(store)
        swrite_groups: dict[tuple, list[_Pending]] = {}
        dec_items: list[_Pending] = []
        per_item: list[_Pending] = []   # roi / frame / chain decode
        for p in batch:
            if p.kind == "compress":
                comp_groups.setdefault(p.args[2:], []).append(p)
            elif p.kind == "chain":
                chain_groups.setdefault(p.args[2:4], []).append(p)
            elif p.kind == "store_roi":
                sroi_groups.setdefault(id(p.args[0]), []).append(p)
            elif p.kind == "store_tiles":
                stile_groups.setdefault(id(p.args[0]), []).append(p)
            elif p.kind == "store_write":
                swrite_groups.setdefault(
                    (id(p.args[0]),) + p.args[4:], []
                ).append(p)
            elif p.kind == "decompress":
                dec_items.append(p)
            else:
                per_item.append(p)

        for (mode, order), members in comp_groups.items():
            self._run_many(
                members,
                lambda ms, cb: engine.compress_many(
                    [p.args[0] for p in ms], [p.args[1] for p in ms], mode,
                    order, self.config.solver, self.config.plan,
                    group_cb=cb, encode_path=self.config.encode_path,
                    adaptive_eb=self.config.adaptive_eb,
                    device=self.config.device,
                ),
            )
        for (mode, order), members in chain_groups.items():
            self._run_many(
                members,
                lambda ms, cb: temporal.compress_chains(
                    [p.args[0] for p in ms], [p.args[1] for p in ms], mode,
                    order, self.config.solver, self.config.plan,
                    keyframe_interval=[p.args[4] for p in ms],
                    group_cb=cb, encode_path=self.config.encode_path,
                    adaptive_eb=self.config.adaptive_eb,
                    device=self.config.device,
                ),
            )
        if dec_items:
            self._run_many(
                dec_items,
                lambda ms, cb: engine.decompress_many(
                    [p.args[0] for p in ms], plan=self.config.plan,
                    group_cb=cb, decode_path=self.config.decode_path,
                    device=self.config.device,
                ),
            )
        for members in sroi_groups.values():
            store = members[0].args[0]
            self._run_many(
                members,
                lambda ms, cb, s=store: s.read_roi_many(
                    [(p.args[1], p.args[2]) for p in ms], stats_cb=cb,
                ),
                record=rec.record_store_read,
            )
        for members in stile_groups.values():
            store = members[0].args[0]
            self._run_many(
                members,
                lambda ms, cb, s=store: s.read_tiles_many(
                    [(p.args[1], p.args[2]) for p in ms], stats_cb=cb,
                ),
                record=rec.record_store_read,
            )
        for members in swrite_groups.values():
            store = members[0].args[0]
            mode, order = members[0].args[4], members[0].args[5]
            self._run_many(
                members,
                lambda ms, cb, s=store, m=mode, o=order: s.write_many(
                    [p.args[1] for p in ms], [p.args[2] for p in ms],
                    [p.args[3] for p in ms], m, o, group_cb=cb,
                    adaptive_eb=self.config.adaptive_eb,
                ),
            )
        for p in per_item:
            try:
                with obs.span("service.execute", parent=obs.context_of(p.span),
                              kind=p.kind):
                    if p.kind == "roi":
                        out = engine.decompress_roi(
                            p.args[0], p.args[1], plan=self.config.plan,
                            decode_path=self.config.decode_path,
                            device=self.config.device,
                        )
                    elif p.kind == "frame":
                        out = temporal.decompress_frame(
                            p.args[0], p.args[1], plan=self.config.plan,
                            device=self.config.device)
                    elif p.kind == "store_frame":
                        out = p.args[0].read_frame(p.args[1], p.args[2])
                    else:  # chain_decompress
                        out = temporal.decompress_chain(
                            p.args[0], plan=self.config.plan,
                            device=self.config.device)
            except Exception as e:  # noqa: BLE001 - resolved into the Future
                self._resolve(p, error=e)
            else:
                self._resolve(p, result=out)

        tc1 = engine_executor.TRANSFER_COUNTS
        rec.record_batch(
            len(batch), time.monotonic() - t0,
            sum(p.nbytes for p in batch),
            {k: tc1[k] - tc0.get(k, 0) for k in tc1 if tc1[k] - tc0.get(k, 0)},
            traces_added=engine_device.trace_count() - tr0,
        )

    def _run_many(self, members: list[_Pending], fn, record=None) -> None:
        """Run one engine call (``fn(members, group_cb)``) over
        ``members``; on failure, isolate the poison request by retrying
        each member alone so one bad field (wrong dtype, corrupt blob,
        unknown store name) cannot fail its batch neighbors.  Callback
        reports buffer locally and only reach the metrics (via
        ``record``, default the device-group counter) when their call
        succeeded — an aborted batched attempt must not inflate
        occupancy or cache counters.

        Tracing: the shared engine call runs under one ``service.group``
        span parented to the *first* member's request span (a span has
        exactly one parent; the other members' trace ids ride along as a
        ``trace_links`` tag).  A failed batched attempt leaves a
        ``poison_isolation`` flight dump, and each member's solo retry
        runs under a ``service.isolate_retry`` span in its own trace."""
        rec = self.metrics_recorder
        record = record or rec.record_device_group
        infos: list[dict] = []
        try:
            with obs.span("service.group",
                          parent=obs.context_of(members[0].span),
                          kind=members[0].kind, n_requests=len(members)) as g:
                if obs.enabled() and len(members) > 1:
                    g.set_tag("trace_links", sorted(
                        {getattr(p.span, "trace_id", None)
                         for p in members[1:]}
                        - {getattr(members[0].span, "trace_id", None), None}))
                results = fn(members, infos.append)
        except Exception as batch_err:  # noqa: BLE001 - retry assigns blame
            obs.flight_dump(
                "poison_isolation",
                trace_id=getattr(members[0].span, "trace_id", None),
                kind=members[0].kind, n_requests=len(members),
                error=f"{type(batch_err).__name__}: {batch_err}")
            for p in members:
                one: list[dict] = []
                try:
                    with obs.span("service.isolate_retry",
                                  parent=obs.context_of(p.span), kind=p.kind):
                        out = fn([p], one.append)
                except Exception as e:  # noqa: BLE001
                    self._resolve(p, error=e)
                else:
                    for info in one:
                        record(info)
                    self._resolve(p, result=out[0])
        else:
            for info in infos:
                record(info)
            for p, out in zip(members, results):
                self._resolve(p, result=out)

    def _resolve(self, p: _Pending, result=None, error=None) -> None:
        latency = time.monotonic() - p.t_submit
        # the request span closes (and hits the tracer/flight recorder)
        # BEFORE the Future resolves, so a caller that takes the trace's
        # spans right after .result() — the cluster worker piggybacking
        # them onto its LPRC reply — always sees the complete tree
        if error is not None:
            obs.finish_span(p.span, error=error)
            obs.flight_dump(
                "request_failure",
                trace_id=getattr(p.span, "trace_id", None),
                kind=p.kind, error=f"{type(error).__name__}: {error}")
            self.metrics_recorder.record_done(latency, ok=False)
            p.future.set_exception(error)
        else:
            obs.finish_span(p.span)
            self.metrics_recorder.record_done(latency, ok=True)
            p.future.set_result(result)
