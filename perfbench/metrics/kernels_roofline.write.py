"""kernels_roofline.write: percent of the card's memory roofline that the
compress requests' kernels reach: the least time of the request (the raw
field and the container each moved once at peak HBM bandwidth) over the
device time of every kernel and memset the profiler shows for it (copies
left out)."""
from perfbench.harness import peaks


def read(run):
    p = run.profile
    if p is None or run.window.op != "compress" or not p["kernel_us"] or not p["requests"]:
        return None
    least = peaks.least_seconds(p["raw_bytes"], p["container_bytes"], p["device_name"])
    if least is None:
        return None
    return 100.0 * least / (p["kernel_us"] / 1e6)
