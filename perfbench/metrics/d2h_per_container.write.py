"""d2h_per_container.write: bytes the compress requests of the window
downloaded (the program's `TRANSFER_COUNTS["bytes_d2h"]`) over the bytes of
the containers they wrote: the compacted download's overhead (a count)."""


def read(run):
    w = run.window
    total = sum(r["container_bytes"] for r in w.requests)
    if w.op != "compress" or not total:
        return None
    return run.counters.get("bytes_d2h", 0) / total
