"""compress_MBps: raw megabytes (1e6 bytes) of the compress requests
sent in the window over the seconds from its start to the last one's
completion (host clock)."""


def read(run):
    w = run.window
    if w.op != "compress" or not w.requests:
        return None
    return sum(r["raw_bytes"] for r in w.requests) / (w.t_last - w.t0) / 1e6
