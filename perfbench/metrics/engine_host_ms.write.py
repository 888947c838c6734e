"""engine_host_ms.write: mean milliseconds per compress request outside the
executor's stages: the engine's host plan, tiling and serialization (or
container parse and assembly), from the program's spans."""
from perfbench.harness import spans


def read(run):
    return spans.host_ms(run.spans, "compress")
