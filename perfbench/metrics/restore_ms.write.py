"""restore_ms.write: mean milliseconds per compress request in the host's
restore of the downloaded streams (`exec.restore` spans, inside
`exec.download`): the runs' byte-level inverse, the bitmap's repeat
restore and the row popcounts."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.named_ms(run.spans, "compress", ("exec.restore",))
