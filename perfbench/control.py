"""The control of the comparison, on the card at the cells' own size.

    python3 perfbench/control.py --config isabel-f32 --seeds 1 2 3

For each seed it makes the configuration's first pool field as a run
with that seed makes it, puts the plain reference computed one precision
below the configuration's (float32 for float64, the field held in
bfloat16 for float32) in the program's place, and prints the numbers
the comparison reads with their limits: the control must fail one.  The
benchmark's runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from perfbench.harness import fields, spec  # noqa: E402
from perfbench.reference import judge  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    bench = spec.load_benchmark()
    cell = next(w["name"] for w in bench["workloads"] if w["config"] == args.config)
    cfg = spec.resolve(bench, cell).config
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t = time.perf_counter()
        x = fields.make(cfg["generator"], cfg["shape"], cfg["dtype"],
                        fields.field_seed(seed, cfg["name"], 0), dev)
        ref, eps_abs, _ = judge.expected(x, cfg)
        low = judge.control_values(x, cfg)
        nums = {"cells_differing": judge.differing(low, ref),
                "order_violations": judge.order_violations(x, low),
                "max_error_over_bound": judge.max_error(x, low, eps_abs)}
        print(json.dumps({"config": cfg["name"], "seed": seed, "control": nums,
                          "limits": judge.LIMITS, "fails": not judge.passed(
                              dict(nums, unanswered=0)),
                          "seconds": time.perf_counter() - t}), flush=True)
        del x, ref, low
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
