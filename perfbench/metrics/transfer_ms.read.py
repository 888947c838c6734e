"""transfer_ms.read: mean milliseconds per decompress request in the
download of the decoded values (`exec.download`), from the program's
spans."""
from perfbench.harness import spans


def read(run):
    return spans.stage_ms(run.spans, "decompress", ("exec.download",))
