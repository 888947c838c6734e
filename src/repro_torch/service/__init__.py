"""Async micro-batching compression service (the serving layer; port of
``repro.service``).

    from repro_torch.service import CompressionService, ServiceConfig

    cfg = ServiceConfig(plan=CompressionPlan(tile_shape=(16, 16, 64)),
                        max_delay_ms=2.0, max_queue=512)   # device="cuda"
    with CompressionService(cfg) as svc:
        fut = svc.submit_compress(field, eb=1e-2)   # from any thread
        blob = fut.result()
        roi = svc.decompress_roi(blob, (slice(0, 8), slice(0, 8), slice(0, 8)))
        print(svc.metrics().lines())

Concurrent requests submitted within ``max_delay_ms`` of each other are
drained into shared engine micro-batches (one upload/download per device
group); outputs are byte-identical to direct ``engine.compress`` calls.
Temporal chains are first-class requests (``submit_compress_chain`` /
``submit_decompress_frame``): frames at the same time step of concurrent
chains share resident batches.  ``ServiceConfig(device="cpu")`` runs
the kernels' plain versions.
"""
from .metrics import MetricsRecorder, ServiceMetrics, percentile
from .service import (
    CompressionService,
    ServiceConfig,
    ServiceOverloaded,
)

__all__ = [
    "CompressionService",
    "MetricsRecorder",
    "ServiceConfig",
    "ServiceMetrics",
    "ServiceOverloaded",
    "percentile",
]
