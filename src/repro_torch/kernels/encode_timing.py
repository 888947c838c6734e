"""Device time of the integer encode (kernel 2) at every word width and
transform, and of the value encode (kernel 4), at the main path's batch
shapes on synthetic operands.

    PYTHONPATH=src python src/repro_torch/kernels/encode_timing.py

Needs a CUDA card and ``nvcc``.  It imports whichever ``repro_torch`` comes
first on ``PYTHONPATH`` (absolute imports only), so two trees are timed in
one call by running it once with each tree's ``src`` (in turns: A, B, B,
A); a transform the loaded tree does not take is skipped.  Operands are
random walks (the bins of a smooth field: small deltas) and f32 cells of
a few bins' spread.  Each time is CUDA events around 20 calls queued
behind a spin kernel, the median of 3 such runs, as ``phase_clocks``
times.  Prints one JSON object: the card, the tree's path and
``{signature: ms}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from repro_torch.kernels import fused_encode

SHAPES = {16: (2048, 4096), 32: (2048,), 64: (4096,)}  # batch sizes per width
ELEMS = 16384


def queued_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e6 * reps))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    out = {}
    for w, batches in SHAPES.items():
        dt = {16: np.int16, 32: np.int32, 64: np.int64}[w]
        for b in batches:
            walk = np.cumsum(rng.integers(-3, 4, (b, ELEMS)), axis=1)
            ints = torch.from_numpy(walk.astype(dt)).cuda()
            for transform in fused_encode.TRANSFORMS:
                out[f"encode_ints_fused ({b}, {ELEMS}) int{w} {transform}"] = \
                    statistics.median(queued_ms(lambda: fused_encode.encode_ints_fused(
                        ints, 131072 // w, transform)) for _ in range(3))
    x = torch.from_numpy((rng.standard_normal((2048, ELEMS)) * 0.3)
                         .astype(np.float32)).cuda()
    eps = torch.full((2048,), 0.02, dtype=torch.float64, device=x.device)
    for store in (torch.int16, torch.int32):
        w = torch.iinfo(store).bits
        out[f"encode_values_fused (2048, {ELEMS}) f32 -> int{w}"] = statistics.median(
            queued_ms(lambda: fused_encode.encode_values_fused(
                x, eps, 131072 // w, torch.float32, store)) for _ in range(3))
    print(json.dumps({"card": card, "tree": fused_encode.__file__, "ms": out}),
          flush=True)


if __name__ == "__main__":
    main()
