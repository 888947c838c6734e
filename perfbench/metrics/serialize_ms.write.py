"""serialize_ms.write: mean milliseconds per compress request in the
host serialization (`engine.serialize` spans): the sweep diagnostics, the
per-tile RZE sections of both streams, the headers and the containers."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.named_ms(run.spans, "compress", ("engine.serialize",))
