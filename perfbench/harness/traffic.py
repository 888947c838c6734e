"""The one traffic generator: every mix is a data file it reads.

A mix (``traffic/<name>.json``) holds:

    op        "compress" (a writer: each request compresses a field)
              or "decompress" (a reader: each request decodes a
              container that set-up compressed from a field)
    options   keyword arguments of the request beside the configuration's
    clients   closed-loop clients; each waits for its reply before it
              sends again (1: one simulation rank's output step)
    pool      {"min_bytes", "min_fields"}: distinct fields made from the
              seed, at least this many and at least this many raw bytes

Requests visit the pool round-robin from a slot the seed picks, so no two
consecutive requests carry the same field and every seed sends the same
number of requests of each size.
"""
from __future__ import annotations

import math

import numpy as np

from . import fields

OPS = ("compress", "decompress")


def field_bytes(config: dict) -> int:
    return math.prod(config["shape"]) * np.dtype(config["dtype"]).itemsize


def pool_size(config: dict, traffic: dict) -> int:
    pool = traffic.get("pool", {})
    return max(int(pool.get("min_fields", 2)),
               -(-int(pool.get("min_bytes", 0)) // field_bytes(config)))


def make_pool(config: dict, traffic: dict, seed: int, device) -> list[np.ndarray]:
    """The pool's fields as host arrays (the program's input), made on
    ``device`` one at a time."""
    out = []
    for i in range(pool_size(config, traffic)):
        x = fields.make(config["generator"], config["shape"], config["dtype"],
                        fields.field_seed(seed, config["name"], i), device)
        out.append(x.cpu().numpy())
        del x
    return out


def order(n_pool: int, seed: int):
    """Endless pool indices: round-robin from a seed-chosen start."""
    k = int(seed) % n_pool
    while True:
        yield k
        k = (k + 1) % n_pool


def check(traffic: dict) -> None:
    if traffic.get("op") not in OPS:
        raise ValueError(f"traffic op must be one of {OPS}")
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError("only one closed-loop client is generated")
