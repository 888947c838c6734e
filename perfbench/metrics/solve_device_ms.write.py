"""solve_device_ms.write: mean milliseconds per compress request of
stream time in the solve stages (`device_us` of the `exec.solve` spans:
from the stage's first queued work to its last, by CUDA events)."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.device_ms(run.spans, "compress", "exec.solve")
