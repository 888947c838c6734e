"""device_idle_share.write: percent of the profiled window of compress
requests in which no kernel, copy or memset ran on the card (the union of
the device activity in the torch.profiler trace)."""


def read(run):
    p = run.profile
    if p is None or run.window.op != "compress" or not p["window_us"]:
        return None
    return 100.0 * (1.0 - p["busy_us"] / p["window_us"])
