"""parse_ms.read: mean milliseconds per decompress request in the
container parse and the tile work list (`engine.parse` spans)."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.named_ms(run.spans, "decompress", ("engine.parse",))
