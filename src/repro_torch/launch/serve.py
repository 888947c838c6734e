"""Serving launcher of the port: the LOPC compression service, the
store behind it and the sharded store cluster (port of
``repro.launch.serve``'s LOPC modes).

Compression-service mode: a pool of concurrent client threads fires
mixed-shape compress/decompress/ROI requests and one temporal chain each
at the micro-batching service (``repro_torch.service``); the
deadline/size coalescer drains them into shared device batches and the
run reports latency percentiles, batch occupancy and transfer counters:

  PYTHONPATH=src python -m repro_torch.launch.serve --compress-service \\
      --clients 8 --requests-per-client 6 --eb 1e-2 --tile 16,16,64 \\
      --max-delay-ms 5

Store mode: a mixed read/write client pool over a persistent
``LopcStore`` served through the same service: every client writes its
own arrays (store writes coalesce into shared compress batches), then
reads regions: cold regions of its own arrays plus a shared hot region
every client revisits, so the decoded-tile cache's hit counters and the
decoded-tiles-per-request figure show up in the report:

  PYTHONPATH=src python -m repro_torch.launch.serve --store \\
      --clients 8 --requests-per-client 6 --eb 1e-2 --tile 16,16,64

Cluster mode: N shard worker subprocesses (``python -m
repro_torch.cluster.worker``) behind one router; writes scatter, region
reads gather byte-identically to a single-process store, and the run
SIGKILLs a worker mid-serving to show replica failover:

  PYTHONPATH=src python -m repro_torch.launch.serve --cluster 4 \
      --clients 8 --requests-per-client 6

Every mode runs on the CUDA device (cluster mode: the router and every
worker); ``--device cpu`` runs the kernels' plain versions.
Observability: ``--trace-out trace.json`` enables end-to-end tracing and
writes a Perfetto-loadable trace of the run (cluster mode propagates
tracing into the worker subprocesses, whose spans ride home on the LPRC
replies); ``--metrics-dump PATH`` (or ``-`` for stdout) writes the
unified registry as Prometheus text exposition; ``--flight-dir DIR``
makes failure flight dumps land as JSON files there (also exported to
cluster workers).  The reference's LLM mode (``--arch``) is not ported.
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _obs_configure(args) -> None:
    """Enable tracing / flight recording per the --trace-out flags."""
    from repro_torch import obs

    if args.trace_out:
        obs.enable()
    if args.flight_dir:
        obs.FLIGHT.configure(directory=args.flight_dir)


def _obs_report(args, mode: str) -> None:
    """Write the collected trace and/or metrics exposition."""
    from repro_torch import obs

    if args.trace_out:
        spans = obs.tracer().drain()
        obs.write_trace(args.trace_out, spans, meta={"mode": mode})
        n_traces = len({s.trace_id for s in spans})
        print(f"  trace      {len(spans)} spans across {n_traces} traces "
              f"-> {args.trace_out}")
    if args.metrics_dump:
        text = obs.REGISTRY.expose_text()
        if args.metrics_dump == "-":
            print(text, end="")
        else:
            with open(args.metrics_dump, "w") as f:
                f.write(text)
            print(f"  metrics    registry exposition -> {args.metrics_dump}")


def _parse_tile(text):
    if not text or text == "auto":
        return None
    try:
        tile = tuple(int(t) for t in text.split(","))
        if len(tile) != 3 or min(tile) < 1:
            raise ValueError
        return tile
    except ValueError:
        raise SystemExit(
            f"--tile wants three positive ints 't0,t1,t2', got {text!r}"
        )


def _config(args):
    from repro_torch.engine.plan import CompressionPlan
    from repro_torch.service import ServiceConfig

    return ServiceConfig(
        plan=CompressionPlan(tile_shape=_parse_tile(args.tile),
                             batch_tiles=args.batch_tiles),
        solver=args.solver,
        decode_path=args.decode_path,
        encode_path=args.encode_path,
        adaptive_eb=args.adaptive_eb,
        device=args.device,
        max_delay_ms=args.max_delay_ms,
        max_batch_requests=args.max_batch,
        max_queue=args.max_queue,
    )


def _submit_retrying(fn, *a):
    from repro_torch.service import ServiceOverloaded

    while True:
        try:
            return fn(*a)
        except ServiceOverloaded as e:  # honor retry-after
            time.sleep(e.retry_after)


def _client_workload(rng_seed: int, n: int):
    """One client's request stream: mixed shapes, ranks, dtypes."""
    from repro_torch.data.fields import make_scientific_field

    rng = np.random.default_rng(rng_seed)
    names = ["gaussians", "turbulence", "waves", "front"]
    fields = []
    for i in range(n):
        ndim = int(rng.integers(1, 4))
        shape = tuple(int(rng.integers(12, 40)) for _ in range(ndim))
        fields.append(
            make_scientific_field(names[(rng_seed + i) % len(names)], shape,
                                  np.float64 if i % 2 else np.float32,
                                  seed=rng_seed * 97 + i)
        )
    return fields


def serve_compression(args):
    """Drive the micro-batching service with a concurrent client pool.

    Every client thread compresses its own stream of fields, round-trips
    each container (decompress) and reads one ROI, plus one temporal
    chain and a frame of it: the concurrent mixed-kind traffic the
    coalescer exists for.  Outputs are verified byte-identical to direct
    engine calls, so the service layer is pure scheduling, never a
    different compressor.
    """
    from repro_torch import engine, temporal
    from repro_torch.data.fields import make_field_sequence
    from repro_torch.service import CompressionService
    from repro_torch.tda.adaptive import EB_LADDER_K_MAX

    cfg = _config(args)

    def client(cid: int) -> dict:
        # pipelined client: all compresses in flight at once, then the
        # round-trip reads: several requests per client ride each batch
        fields = _client_workload(cid, args.requests_per_client)
        futs = [_submit_retrying(svc.submit_compress, x, args.eb)
                for x in fields]
        # one time series per client: chain steps of concurrent clients
        # coalesce into shared resident frame batches
        chain = make_field_sequence(
            "advect" if cid % 2 else "diffuse", "gaussians", (24, 24, 16),
            args.chain_frames, np.float32, seed=cid,
        )
        cfut = _submit_retrying(svc.submit_compress_chain, chain, args.eb)
        blobs = [f.result() for f in futs]
        chain_blob = cfut.result()
        dfuts = [_submit_retrying(svc.submit_decompress, b) for b in blobs]
        rfuts = [
            _submit_retrying(svc.submit_roi, b,
                             tuple(slice(0, min(8, n)) for n in x.shape))
            for x, b in zip(fields, blobs)
        ]
        ffut = _submit_retrying(svc.submit_decompress_frame, chain_blob,
                                len(chain) - 1)
        # adaptive-eb may loosen tiles up to 2^k_max beyond the user
        # bound (topology permitting): widen the client-side check
        slack = 2.0 ** EB_LADDER_K_MAX if args.adaptive_eb != "off" else 1.0
        for x, df in zip(fields, dfuts):
            y = df.result()
            bound = args.eb * (float(x.max()) - float(x.min())) * slack
            assert np.abs(x.astype(np.float64)
                          - y.astype(np.float64)).max() <= bound
        for x, rf in zip(fields, rfuts):
            assert rf.result().shape == tuple(min(8, n) for n in x.shape)
        last = ffut.result()
        x = chain[-1]
        bound = args.eb * (float(x.max()) - float(x.min())) * slack
        assert np.abs(x.astype(np.float64)
                      - last.astype(np.float64)).max() <= bound
        return {"mb": (sum(x.nbytes for x in fields)
                       + sum(f.nbytes for f in chain)) / 1e6,
                "fields": fields, "blobs": blobs,
                "chain": chain, "chain_blob": chain_blob}

    with CompressionService(cfg) as svc:
        # warm the executor and the kernel libraries off the clock, so the
        # measured run shows steady-state serving latency
        warm = _client_workload(0, 2)
        for b in [svc.submit_compress(x, args.eb) for x in warm]:
            svc.submit_decompress(b.result()).result()
        trace0 = engine.device.trace_count()
        m0 = svc.metrics()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(args.clients) as pool:
            results = list(pool.map(client, range(args.clients)))
        wall = time.perf_counter() - t0
        m = svc.metrics()

    # byte contract, verified off the clock: direct engine.compress calls
    # would also pollute the per-batch transfer-counter deltas the metrics
    # report if they ran concurrently with the service
    for r in results:
        for x, blob in zip(r["fields"], r["blobs"]):
            assert blob == engine.compress(x, args.eb, plan=cfg.plan,
                                           solver=cfg.solver,
                                           adaptive_eb=cfg.adaptive_eb,
                                           device=cfg.device)
        assert r["chain_blob"] == temporal.compress_chain(
            r["chain"], args.eb, plan=cfg.plan, solver=cfg.solver,
            adaptive_eb=cfg.adaptive_eb, device=cfg.device)

    total_mb = sum(r["mb"] for r in results)
    n_req = m.completed - m0.completed
    occ = ((m.mean_batch_occupancy * m.batches
            - m0.mean_batch_occupancy * m0.batches)
           / max(1, m.batches - m0.batches))
    print(f"compression service: {args.clients} concurrent clients x "
          f"{args.requests_per_client} fields (mixed 1/2/3-D f32/f64) "
          f"+ one {args.chain_frames}-frame temporal chain each, "
          f"solver={args.solver}, device={cfg.device}")
    print(f"  completed  {n_req} requests ({total_mb:.2f} MB compressed) "
          f"in {wall:.2f}s wall")
    print(f"  latency    p50 {m.p50_ms:.1f} ms / p99 {m.p99_ms:.1f} ms "
          f"(window incl. warmup)")
    print(f"  batching   {m.batches - m0.batches} micro-batches, "
          f"occupancy mean {occ:.2f} / max {m.max_batch_occupancy}")
    print(f"  traces     +{engine.device.trace_count() - trace0} after "
          f"warmup (kernel libraries built or loaded; warm traffic adds 0)")
    pad_real = m.bucket_real_tiles - m0.bucket_real_tiles
    pad_dead = m.bucket_padded_tiles - m0.bucket_padded_tiles
    caps = {c: m.bucket_batches.get(c, 0) - m0.bucket_batches.get(c, 0)
            for c in sorted(m.bucket_batches)
            if m.bucket_batches.get(c, 0) - m0.bucket_batches.get(c, 0)}
    print(f"  buckets    pad waste "
          f"{pad_dead / pad_real if pad_real else 0.0:.2f} "
          f"({pad_dead} padded / {pad_real} real tiles) over "
          f"capacities {caps}")
    print(f"  transfers  {m.transfers}")
    print(f"  rejections {m.rejected - m0.rejected} "
          f"(backpressure, retried by clients)")


def serve_store(args):
    """Drive a store-backed mixed read/write pool through the service.

    Clients write their own arrays through the service (writes coalesce
    into shared compress batches + one manifest swap per batch), then
    issue region reads: each client's own regions (cold, decoded from
    disk tile by tile) and one shared hot region (every client after the
    first hits the decoded-tile cache), and one frame of a stored chain.
    All reads are verified byte-identical to slicing a direct engine
    decompress: the cache can change latency, never bytes.
    """
    import shutil
    import tempfile

    from repro_torch import engine
    from repro_torch.data.fields import make_field_sequence, make_scientific_field
    from repro_torch.service import CompressionService
    from repro_torch.store import LopcStore

    cfg = _config(args)
    root = args.store_dir or tempfile.mkdtemp(prefix="lopc-store-")
    store = LopcStore(root, create=True, plan=cfg.plan, solver=cfg.solver,
                      device=cfg.device)

    hot_shape = (48, 48, 32)
    hot = make_scientific_field("turbulence", hot_shape, np.float32, seed=7)
    hot_roi = tuple(slice(8, 24) for _ in range(3))

    def client(cid: int) -> dict:
        rng = np.random.default_rng(1000 + cid)
        names, fields, wfuts = [], [], []
        for i in range(args.requests_per_client):
            x = make_scientific_field(
                ["gaussians", "waves", "front"][i % 3], (32, 32, 24),
                np.float64 if i % 2 else np.float32, seed=cid * 131 + i,
            )
            name = f"c{cid}_f{i}"
            names.append(name)
            fields.append(x)
            wfuts.append(_submit_retrying(
                svc.submit_store_write, store, name, x, args.eb))
        for f in wfuts:
            f.result()
        # reads: one cold region per own array + the shared hot region
        rois, rfuts = [], []
        for name, x in zip(names, fields):
            lo = tuple(int(rng.integers(0, n // 2)) for n in x.shape)
            roi = tuple(slice(a, min(a + 12, n))
                        for a, n in zip(lo, x.shape))
            rois.append((name, roi, x))
            rfuts.append(_submit_retrying(
                svc.submit_store_roi, store, name, roi))
        hfut = _submit_retrying(svc.submit_store_roi, store, "hot", hot_roi)
        ffut = _submit_retrying(svc.submit_store_frame, store, "evolution",
                                args.chain_frames - 1)
        for (name, roi, x), f in zip(rois, rfuts):
            got = f.result()
            bound = args.eb * (float(x.max()) - float(x.min()))
            assert np.abs(x[roi].astype(np.float64)
                          - got.astype(np.float64)).max() <= bound, name
        hot_read = hfut.result()
        last = ffut.result()
        return {"mb": sum(x.nbytes for x in fields) / 1e6,
                "rois": rois, "hot_read": hot_read, "frame": last}

    try:
        with CompressionService(cfg) as svc:
            svc.submit_store_write(store, "hot", hot, args.eb).result()
            chain = make_field_sequence("advect", "gaussians", (24, 24, 16),
                                        args.chain_frames, np.float32, seed=3)
            store.write_chain("evolution", chain, args.eb)
            svc.submit_store_roi(store, "hot", hot_roi).result()  # warm
            m0 = svc.metrics()

            t0 = time.perf_counter()
            with ThreadPoolExecutor(args.clients) as pool:
                results = list(pool.map(client, range(args.clients)))
            wall = time.perf_counter() - t0
            m = svc.metrics()

        # byte contract, verified off the clock: store reads == slices of
        # a direct engine decompress of the stored container bytes
        for r in results:
            for name, roi, _x in r["rois"]:
                blob = (store.root / store.info(name)["payload"]).read_bytes()
                assert np.array_equal(
                    store.read_roi(name, roi),
                    engine.decompress(blob, plan=cfg.plan,
                                      device=cfg.device)[roi]), name
            assert np.array_equal(r["hot_read"], results[0]["hot_read"])

        total_mb = sum(r["mb"] for r in results)
        print(f"store service: {args.clients} clients x "
              f"{args.requests_per_client} arrays each + shared hot region "
              f"+ chain frame reads over {root}, device={cfg.device}")
        print(f"  completed  {m.completed - m0.completed} requests "
              f"({total_mb:.2f} MB written) in {wall:.2f}s wall")
        print(f"  latency    p50 {m.p50_ms:.1f} ms / p99 {m.p99_ms:.1f} ms")
        print(f"  batching   {m.batches - m0.batches} micro-batches, "
              f"occupancy mean {m.mean_batch_occupancy:.2f} / "
              f"max {m.max_batch_occupancy}")
        print(f"  tile cache {m.cache_hits - m0.cache_hits} hits / "
              f"{m.cache_misses - m0.cache_misses} misses / "
              f"{m.cache_evictions - m0.cache_evictions} evictions; "
              f"{m.decoded_tiles_per_request:.2f} decoded tiles/request")
        print(f"  store      {len(store.names())} arrays, cache "
              f"{store.cache.stats()}")
        assert m.cache_hits > m0.cache_hits, \
            "hot-region reads never hit the decoded-tile cache"
    finally:
        store.close()
        if not args.store_dir:
            shutil.rmtree(root, ignore_errors=True)


def serve_cluster(args):
    """Drive a sharded store cluster: N worker subprocesses, one router.

    Spawns ``--cluster N`` shard workers (``python -m
    repro_torch.cluster.worker``, each a real ``LopcStore`` directory
    under a real ``CompressionService``, behind a TCP socket, on
    ``--device``), scatters client writes through the router, hammers
    concurrent region reads, then SIGKILLs one worker mid-serving and
    keeps reading — the replica serves the dead shard's tiles and every
    read stays byte-identical to a single-process store on the same
    device.  Ends with the ``ClusterMetrics`` report: per-shard health,
    replica-served tiles, and the workers' aggregated service metrics.
    """
    import shutil
    import tempfile

    from repro_torch.cluster import ProcessCluster
    from repro_torch.data.fields import make_scientific_field
    from repro_torch.engine.plan import CompressionPlan
    from repro_torch.store import LopcStore

    plan = CompressionPlan(tile_shape=_parse_tile(args.tile),
                           batch_tiles=args.batch_tiles)
    root = args.store_dir or tempfile.mkdtemp(prefix="lopc-cluster-")
    n_shards = args.cluster
    shape = (48, 48, 32)
    names = [f"field{i}" for i in range(max(2, args.requests_per_client))]
    rois = [tuple(slice(4 * i, 4 * i + 16) for _ in range(3))
            for i in range(4)]

    child_env = None
    if args.trace_out:
        # workers trace from import time; their spans piggyback home on
        # LPRC replies, so the router-side trace file holds the cluster
        child_env = {"LOPC_TRACE": "1"}
        if args.flight_dir:
            child_env["LOPC_FLIGHT_DIR"] = args.flight_dir

    try:
        with ProcessCluster(root + "/shards", n_shards, plan=plan,
                            n_replicas=min(2, n_shards),
                            adaptive_eb=args.adaptive_eb,
                            env=child_env, device=args.device) as cluster:
            router = cluster.router
            fields = {}
            t0 = time.perf_counter()
            for i, name in enumerate(names):
                x = make_scientific_field(
                    ["gaussians", "turbulence", "waves"][i % 3], shape,
                    np.float32, seed=50 + i)
                fields[name] = x
                router.write(name, x, args.eb)
            t_write = time.perf_counter() - t0

            # single-process reference for the byte contract
            ref = LopcStore.create(root + "/ref", plan=plan,
                                   device=args.device)
            for name, x in fields.items():
                ref.write(name, x, args.eb, adaptive_eb=args.adaptive_eb)

            def read_all() -> float:
                t0 = time.perf_counter()
                with ThreadPoolExecutor(args.clients) as pool:
                    outs = list(pool.map(
                        lambda i: router.read_roi(names[i % len(names)],
                                                  rois[i % len(rois)]),
                        range(args.clients * args.requests_per_client)))
                dt = time.perf_counter() - t0
                for i, got in enumerate(outs):
                    want = ref.read_roi(names[i % len(names)],
                                        rois[i % len(rois)])
                    if got.tobytes() != want.tobytes():
                        raise SystemExit(f"cluster read {i} diverged from "
                                         "the single-process store")
                return dt

            t_healthy = read_all()
            victim = router.map.owners(names[0], 0)[0]
            cluster.kill(victim)
            t_degraded = read_all()
            snap = router.cluster_metrics()
            ref.close()

        mb = (sum(x.nbytes for x in fields.values())
              * args.clients * args.requests_per_client
              / len(names) / 1e6)
        print(f"cluster: {n_shards} shard workers (subprocesses), "
              f"replication x{min(2, n_shards)}, {args.clients} clients, "
              f"device={args.device}")
        print(f"  writes     {len(names)} arrays scattered in "
              f"{t_write:.2f}s")
        print(f"  reads      {args.clients * args.requests_per_client} "
              f"region reads, byte-identical to a single-process store: "
              f"healthy {t_healthy:.2f}s, after SIGKILL of shard "
              f"{victim} {t_degraded:.2f}s (~{mb:.1f} MB served)")
        for line in router.metrics.lines(snap["workers"]):
            print(f"  {line}")
    finally:
        if not args.store_dir:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve LOPC compression requests on the port")
    ap.add_argument("--arch", default=None,
                    help="the reference's LLM serving mode (not ported: "
                         "ROADMAP.md module queue row 15)")
    ap.add_argument("--compress-service", action="store_true",
                    help="serve concurrent LOPC compression requests "
                         "through the micro-batching service")
    ap.add_argument("--store", action="store_true",
                    help="drive a mixed read/write client pool over a "
                         "persistent LopcStore through the service "
                         "(store-backed reads, decoded-tile cache)")
    ap.add_argument("--cluster", type=int, default=None, metavar="N",
                    help="serve a sharded store cluster: N shard worker "
                         "subprocesses behind one router; writes scatter, "
                         "reads gather byte-identically, and the demo "
                         "SIGKILLs a worker mid-serving to show replica "
                         "failover")
    ap.add_argument("--store-dir", default=None,
                    help="store mode: directory to hold the store (default: "
                         "a fresh temp dir, removed after the run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the service and the store run on "
                         "(cluster mode: the router and every worker; "
                         "cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--eb", type=float, default=1e-2,
                    help="compression service: NOA error bound")
    ap.add_argument("--tile", default="16,16,64",
                    help="compression service: fixed tile shape t0,t1,t2 "
                         "(the shape-stable production plan); pass "
                         "'auto' for per-request auto tiling")
    ap.add_argument("--batch-tiles", type=int, default=8)
    ap.add_argument("--clients", type=int, default=8,
                    help="compression service: concurrent client threads")
    ap.add_argument("--requests-per-client", type=int, default=6)
    ap.add_argument("--chain-frames", type=int, default=4,
                    help="frames in each client's temporal chain request")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="coalescer deadline: how long a lone request "
                         "waits for batch company")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="coalescer size cap per micro-batch")
    ap.add_argument("--max-queue", type=int, default=512,
                    help="bounded queue depth (backpressure threshold)")
    ap.add_argument("--solver", default="auto",
                    choices=["auto", "jacobi", "frontier", "blockwise"],
                    help="subbin schedule (bytes are schedule-independent; "
                         "the tile solve always runs kernel 1)")
    ap.add_argument("--decode-path", default="auto",
                    choices=["staged", "fused", "auto"],
                    help="the reference's decompress paths; every one runs "
                         "the port's decode kernel (bytes are "
                         "path-independent)")
    ap.add_argument("--encode-path", default="auto",
                    choices=["staged", "fused", "auto"],
                    help="compress download form: staged chunk rows, or the "
                         "device-compacted ~payload-size download; auto "
                         "picks the compacted form for large CUDA batches "
                         "(bytes are path-independent)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable end-to-end tracing and write a "
                         "Perfetto-loadable Chrome trace JSON of the run "
                         "(cluster mode propagates tracing into the "
                         "worker subprocesses)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the unified metrics registry as "
                         "Prometheus text exposition at the end of the "
                         "run ('-' for stdout)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="write failure flight-recorder dumps as JSON "
                         "files into DIR (also exported to cluster "
                         "workers)")
    ap.add_argument("--adaptive-eb", default="off",
                    choices=["off", "tda"],
                    help="topology-adaptive per-tile error bounds (the eb "
                         "ladder {eb * 2^-k}); local order and critical "
                         "points stay exactly preserved either way")
    args = ap.parse_args(argv)

    if args.arch:
        raise SystemExit("--arch (LLM serving) is not ported: ROADMAP.md "
                         "module queue row 15 (the LM scaffold) decides it")
    _parse_tile(args.tile)  # a malformed --tile exits before any work
    _obs_configure(args)
    if args.cluster:
        serve_cluster(args)
        _obs_report(args, "cluster")
        return
    if args.store:
        serve_store(args)
        _obs_report(args, "store")
        return
    if args.compress_service:
        serve_compression(args)
        _obs_report(args, "compress-service")
        return
    raise SystemExit("pass --compress-service, --store or --cluster N "
                     "(--arch is not ported)")


if __name__ == "__main__":
    main()
