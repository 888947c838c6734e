"""Wall time of the engine's compress and decompress at full size:
chip_smoke.py's isabel field ("turbulence", (100, 500, 500) f32, seed 0)
at its 1e-2 bound, warm, on the card.

    PYTHONPATH=src python src/repro_torch/engine/wall_timing.py [--reps 7]

Needs a CUDA card and ``nvcc``.  It imports whichever ``repro_torch``
comes first on ``PYTHONPATH`` (absolute imports only), so two trees are
timed in one call by running it once with each tree's ``src`` (in turns:
A, B, B, A).  One untimed compress and decompress load the kernel
libraries and build the field's tables first; every timed pass must give
the first pass's bytes and values again.  Where the tree has
``repro_torch.obs``, the same passes are timed again with tracing on.
Prints one JSON object: the card, the tree's path, each pass's seconds
and their medians.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import engine
from repro_torch.data.fields import make_scientific_field

EB = 1e-2


def passes(x, blob, y, reps: int) -> tuple[list, list]:
    tc, td = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = engine.compress(x, EB)
        tc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        v = engine.decompress(b)
        td.append(time.perf_counter() - t0)
        if b != blob or v.tobytes() != y.tobytes():
            raise SystemExit("a warm pass gave other bytes or values")
    return tc, td


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    x = make_scientific_field("turbulence", (100, 500, 500), np.float32, seed=0)
    blob = engine.compress(x, EB)
    y = engine.decompress(blob)
    out = {"card": card,
           "tree": str(Path(engine.__file__).resolve().parents[3])}
    tc, td = passes(x, blob, y, args.reps)
    out.update(compress_s=tc, decompress_s=td,
               compress_median=statistics.median(tc),
               decompress_median=statistics.median(td))
    try:
        from repro_torch import obs
    except ImportError:
        obs = None
    if obs is not None:
        obs.enable()
        try:
            tc, td = passes(x, blob, y, args.reps)
        finally:
            obs.disable()
            obs.tracer().drain()
        out.update(traced_compress_s=tc, traced_decompress_s=td,
                   traced_compress_median=statistics.median(tc),
                   traced_decompress_median=statistics.median(td))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
