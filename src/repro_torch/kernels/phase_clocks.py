"""Where the fused decode (kernels 3, 3') and encode (kernels 2, 4) spend
their time, by phase, from in-kernel ``clock64()`` counters.

    PYTHONPATH=src python -m repro_torch.kernels.phase_clocks

Needs a CUDA card and ``nvcc``.  It compresses and decompresses the
ISABEL-shaped (100x500x500 float32, turbulence) and Miranda-shaped
(256x384x384 float64, gaussians) fields of ``chip_smoke.py`` through the
engine, on both the order-preserving and the plain path, and keeps the
operands of the first call of each kernel signature.  Then it builds
``fused_decode.cu`` and ``fused_encode.cu`` again with
``-DLOPC_PHASE_CLOCKS`` (``csrc/clocks.cuh``: thread 0 of each CTA reads
``clock64()`` after the barrier that ends each phase and sums the cycles
per phase slot into a device buffer) and runs each kept call through
that build.  Prints, per call, each slot's cycles summed over the CTAs of
one launch, its hits per launch, its share of the barrier-delimited
slots and the kernel's device time per launch in both builds (CUDA
events around calls queued behind a spin kernel).
Writes the same to ``chiprun_out/phase_clocks.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import engine
from ..data.fields import make_scientific_field
from ..engine import device
from . import _lib, fused_decode, fused_encode

CLOCKS = ("LOPC_PHASE_CLOCKS",)
FIELDS = (("turbulence", (100, 500, 500), "float32"),
          ("gaussians", (256, 384, 384), "float64"))
WRAPPERS = {"encode_ints_fused": ("fused_encode", fused_encode),
            "encode_values_fused": ("fused_encode", fused_encode),
            "decode_tiles_fused": ("fused_decode", fused_decode)}


def _signature(name: str, args) -> str:
    if name == "decode_tiles_fused" and args[2] is None:
        name = "decode_tiles_fused_nosub"
    shapes = [f"{tuple(a.shape)} {str(a.dtype)[6:]}" for a in args
              if isinstance(a, torch.Tensor)]
    rest = [str(a) for a in args if not isinstance(a, torch.Tensor)
            and a is not None]
    return f"{name}: " + ", ".join(shapes + rest)


def record_calls() -> dict:
    """The operands of the first call of each kernel signature of the
    engine's compress and decompress of both fields, both paths."""
    kept: dict[str, tuple] = {}
    real = {n: getattr(device, n) for n in WRAPPERS}

    def wrap(name):
        def wrapped(*args):
            kept.setdefault(_signature(name, args), (name, args))
            return real[name](*args)
        return wrapped

    try:
        for n in WRAPPERS:
            setattr(device, n, wrap(n))
        for gen, shape, dtype in FIELDS:
            x = make_scientific_field(gen, shape, np.dtype(dtype), seed=0)
            for kw in ({}, {"preserve_order": False}):
                engine.decompress(engine.compress(x, 1e-2, **kw))
    finally:
        for n, f in real.items():
            setattr(device, n, f)
    return kept


def _device_ms(fn, reps: int) -> float:
    """Device time per call: CUDA events around ``reps`` back-to-back
    calls queued behind a spin kernel that outlasts the host's
    enqueueing, so the host's time between launches does not count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1e6 * reps))  # about 0.5 ms a call at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clock_breakdown(name: str, args, reps: int = 5) -> dict:
    """Run one kept call through the clock build ``reps`` times."""
    lib_name, mod = WRAPPERS[name]
    fn = getattr(mod, name)
    plain_ms = _device_ms(lambda: fn(*args), 20)
    real_call = _lib.call

    def clocked(lib, f, *a):
        return real_call(lib, f, *a, defines=CLOCKS)

    lib = _lib.library(lib_name, CLOCKS)
    lib.lopc_clock_names.restype = ctypes.c_char_p
    names = lib.lopc_clock_names().decode().split(",")
    sums = (ctypes.c_ulonglong * 16)()
    hits = (ctypes.c_ulonglong * 16)()
    _lib.call = clocked
    try:
        clocked_ms = _device_ms(lambda: fn(*args), 20)
        _lib.library(lib_name, CLOCKS).lopc_clock_read(sums, hits)  # reset
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
        err = lib.lopc_clock_read(sums, hits)
    finally:
        _lib.call = real_call
    if err:
        raise RuntimeError(f"lopc_clock_read failed (cudaError {err})")
    slots = [{"phase": n, "cycles_per_launch": sums[k] / reps,
              "hits_per_launch": hits[k] / reps,
              "cycles_per_hit": sums[k] / hits[k]}
             for k, n in enumerate(names) if hits[k]]
    total = sum(s["cycles_per_launch"] for s in slots)
    for s in slots:
        s["share"] = s["cycles_per_launch"] / total
    return {"ms": plain_ms, "clock_build_ms": clocked_ms,
            "cta_cycles_per_launch": total, "slots": slots}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    props = torch.cuda.get_device_properties(0)
    out = {"card": card, "sms": props.multi_processor_count,
           "sm_clock_khz": getattr(props, "clock_rate", None), "calls": {}}
    print(f"card: {card}", flush=True)
    for sig, (name, args) in record_calls().items():
        res = clock_breakdown(name, args)
        out["calls"][sig] = res
        print(f"{sig}: {res['ms']:.4f} ms ({res['clock_build_ms']:.4f} ms "
              f"with clocks), {res['cta_cycles_per_launch']:.4g} CTA-cycles "
              "per launch", flush=True)
        for s in res["slots"]:
            print(f"    {s['share']:.3f}  {s['phase']:<40} {s['cycles_per_hit']:10.1f} "
                  f"cycles x {s['hits_per_launch']:.0f}", flush=True)
    path = Path(_lib.BUILD_DIR).parents[1] / "chiprun_out" / "phase_clocks.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
