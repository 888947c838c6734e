"""solve_ms.write: mean milliseconds per compress request in the device
stages up to the encode: quantize, order flags, halo gathers and the
rounds of kernel 1 (`exec.solve` spans)."""
from perfbench.harness import spans


def read(run):
    return spans.stage_ms(run.spans, "compress", ("exec.solve",))
