"""pad_share.write: percent of the bytes the compress requests of the
window uploaded (the program's `TRANSFER_COUNTS["bytes_h2d"]`) that were
pad rows of a resident batch (`bytes_h2d_pad`: tiles, eps, halo index
and mask rows past the batch's real tiles).  None where the program
counts no pad bytes."""


def read(run):
    c = run.counters
    if run.window.op != "compress" or "bytes_h2d_pad" not in c or not c.get("bytes_h2d"):
        return None
    return 100.0 * c["bytes_h2d_pad"] / c["bytes_h2d"]
