"""Quickstart on the PyTorch/CUDA port: compress a scalar field with
LOPC, verify the paper's guarantees (error bound, all critical points,
full local order).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions

The port of ``examples/quickstart.py``: the same field and bounds
through ``repro_torch`` (it imports neither ``jax`` nor ``repro``).
"""
import argparse

import numpy as np

from repro_torch.core import compress, decompress
from repro_torch.data.fields import make_scientific_field
from repro_torch.tda import critical_point_errors, local_order_violations, psnr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shape", default=None,
                    help="field shape, e.g. 32,48,48 (default: the "
                         "Miranda-like stand-in's)")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(",")) if args.shape else None
    dev = args.device

    x = make_scientific_field("miranda", shape)  # synthetic Miranda-like field
    print(f"field: {x.shape} {x.dtype}, {x.nbytes / 1e6:.1f} MB, on {dev}")

    for eb in (1e-2, 1e-4):
        blob, stats = compress(x, eb=eb, mode="noa", return_stats=True,
                               device=dev)
        y = decompress(blob, device=dev)

        bound = eb * (x.max() - x.min())
        fp, fn, ft = critical_point_errors(x, y, device=dev)
        print(
            f"NOA {eb:g}: ratio {stats.ratio:.2f}x "
            f"(bins {stats.bin_bytes}B, subbins {stats.subbin_bytes}B, "
            f"{stats.n_sweeps} solver sweeps) | "
            f"max err {np.abs(x - y).max():.3e} <= {bound:.3e} | "
            f"critical points FP/FN/FT = {fp}/{fn}/{ft} | "
            f"order violations = {local_order_violations(x, y, device=dev)} | "
            f"PSNR {psnr(x, y):.1f} dB"
        )
        assert np.abs(x - y).max() <= bound
        assert (fp, fn, ft) == (0, 0, 0)


if __name__ == "__main__":
    main()
