"""tiling_ms.write: mean milliseconds per compress request building the
haloed tile batch on the host (`engine.tile` spans: the bordered copy,
the halo tiles, their concatenation) and joining the pad rows to it
(`exec.pad` spans)."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.named_ms(run.spans, "compress", ("engine.tile", "exec.pad"))
