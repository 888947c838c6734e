"""assemble_ms.read: mean milliseconds per decompress request joining the
decode batches' values (`exec.concat` spans) and assembling the field
from the tile interiors (`engine.assemble` spans)."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.named_ms(run.spans, "decompress", ("engine.assemble", "exec.concat"))
