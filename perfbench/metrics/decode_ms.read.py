"""decode_ms.read: mean milliseconds per decompress request in the
upload of the section rows and kernel 3 (`exec.decode` spans)."""
from perfbench.harness import spans


def read(run):
    return spans.stage_ms(run.spans, "decompress", ("exec.decode",))
