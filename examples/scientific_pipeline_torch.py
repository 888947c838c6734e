"""The paper's own deployment scenario on the PyTorch/CUDA port: a
simulation emitting timesteps faster than storage can absorb them.  LOPC
compresses each step with a guaranteed bound while preserving every
critical point, so downstream topological analysis (feature tracking
across timesteps) stays exact.

    PYTHONPATH=src python examples/scientific_pipeline_torch.py               # on the GPU
    PYTHONPATH=src python examples/scientific_pipeline_torch.py --device cpu  # plain versions

The port of ``examples/scientific_pipeline.py`` (it imports neither
``jax`` nor ``repro``).
"""
import argparse
import time

import numpy as np

from repro_torch.core import compress, decompress
from repro_torch.data.fields import make_scientific_field
from repro_torch.tda import classify_critical_points


def simulate(step: int, shape=None) -> np.ndarray:
    """Stand-in for a running simulation (evolving turbulence field)."""
    return make_scientific_field("isabel", shape, seed=step)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timesteps", type=int, default=4)
    ap.add_argument("--shape", default=None,
                    help="field shape, e.g. 24,48,48 (default: the "
                         "ISABEL-like stand-in's)")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(",")) if args.shape else None
    dev = args.device

    total_raw = total_stored = 0
    t0 = time.perf_counter()
    for step in range(args.timesteps):
        field = simulate(step, shape)
        blob, stats = compress(field, eb=1e-2, mode="noa", return_stats=True,
                               device=dev)
        total_raw += stats.raw_bytes
        total_stored += stats.total_bytes

        # downstream analysis on the archived (decompressed) data:
        y = decompress(blob, device=dev)
        cls = classify_critical_points(y, device=dev).cpu().numpy()
        census = {int(c): int((cls == c).sum()) for c in (1, 2, 3)}
        cls_orig = classify_critical_points(field, device=dev).cpu().numpy()
        assert np.array_equal(cls, cls_orig), "topology must survive the archive"
        print(f"t={step}: {stats.ratio:.2f}x, critical points "
              f"min/max/saddle = {census[1]}/{census[2]}/{census[3]} "
              f"(identical to the live field)")
    dt = time.perf_counter() - t0
    print(f"archived {total_raw / 1e6:.1f} MB as {total_stored / 1e6:.1f} MB "
          f"({total_raw / total_stored:.2f}x) at "
          f"{total_raw / 1e6 / dt:.1f} MB/s end-to-end on {dev}")


if __name__ == "__main__":
    main()
