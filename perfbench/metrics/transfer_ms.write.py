"""transfer_ms.write: mean milliseconds per compress request in the
executor's copies: the upload (`exec.upload`) and the compacted download
(`exec.download`, its compaction included), from the program's spans."""
from perfbench.harness import spans


def read(run):
    return spans.stage_ms(run.spans, "compress", ("exec.upload", "exec.download"))
