"""plan_ms.write: mean milliseconds per compress request in the engine's
host plan (`engine.plan` spans): the requests' validation, non-finite
scan, value range and bin width, the executor pick and the grouping."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.named_ms(run.spans, "compress", ("engine.plan",))
