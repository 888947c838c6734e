"""stream_prep_ms.read: mean milliseconds per decompress request in the
host's section parse into kernel rows (`exec.stream_prep` spans)."""
from perfbench.harness import spans


def read(run):
    return spans.stage_ms(run.spans, "decompress", ("exec.stream_prep",))
