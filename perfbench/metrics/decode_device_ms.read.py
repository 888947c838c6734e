"""decode_device_ms.read: mean milliseconds per decompress request of
stream time in the decode stages (`device_us` of the `exec.decode` spans:
the rows' upload and kernel 3, by CUDA events)."""
from perfbench.harness import host_spans


def read(run):
    return host_spans.device_ms(run.spans, "decompress", "exec.decode")
