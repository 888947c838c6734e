"""unattributed_ms.write: mean milliseconds per compress request that no
span of its trace covers but the request's own and the engine's groups:
the request's wall time minus the union of every other span."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.unattributed_ms(run.spans, "compress")
