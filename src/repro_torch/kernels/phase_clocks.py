"""Where the fused decode (kernels 3, 3'), the fused encodes (kernels 2,
4) and the BIT_4 transpose (kernel 8) spend their time, by phase, from
in-kernel ``clock64()`` counters.

    PYTHONPATH=src python -m repro_torch.kernels.phase_clocks

Needs a CUDA card and ``nvcc``.  It compresses and decompresses the
ISABEL-shaped (100x500x500 float32, turbulence) and Miranda-shaped
(256x384x384 float64, gaussians) fields of ``chip_smoke.py`` through the
engine, on both the order-preserving and the plain path, and the
ISABEL-shaped field through the whole-field (v1) compressor and, as a
two-frame temporal chain (its residual frame: kernel 2's zigzag), and
keeps the operands of the first call of each kernel signature.  Then it builds
``fused_decode.cu``, ``fused_encode.cu`` and ``bitshuffle.cu`` again with
``-DLOPC_PHASE_CLOCKS`` (``csrc/clocks.cuh``: thread 0 of each CTA reads
``clock64()`` after the barrier that ends each phase and sums the cycles
per phase slot into a device buffer) and runs each kept call through
that build.  Prints, per call, each slot's cycles summed over the CTAs of
one launch, its hits per launch, its share of the barrier-delimited
slots and the kernel's device time per launch in both builds (CUDA
events around calls queued behind a spin kernel); for a kernel with
another design kept under a define (``VARIANTS``: the BIT_4 inverse
with straight stores, ``-DLOPC_STRAIGHT_STORE``; the value encode at the
compiler's own register budget, ``-DLOPC_OWN_REGISTERS``), the same for
the clock build of that design.  A slot that counts events (the value
encode's cells quantized by the reference's sequence) has no cycles:
its hits are the events.
Writes the same to ``chiprun_out/phase_clocks.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import core, engine, temporal
from ..data.fields import make_field_sequence, make_scientific_field
from ..engine import device
from . import _lib, bitshuffle_kernel, fused_decode, fused_encode

CLOCKS = ("LOPC_PHASE_CLOCKS",)
FIELDS = (("turbulence", (100, 500, 500), "float32"),
          ("gaussians", (256, 384, 384), "float64"))
# kernel name -> (library, module of the wrapper, module the paths call
# it through)
# other designs of a kernel, built beside its clock build (both carry
# the marks): the BIT_4 inverse storing its words straight to device
# memory instead of through its shared stage; the value encode at the
# register budget the compiler picks on its own
VARIANTS = {"bitunshuffle_u32": ("LOPC_STRAIGHT_STORE",),
            "encode_values_fused": ("LOPC_OWN_REGISTERS",)}
WRAPPERS = {"encode_ints_fused": ("fused_encode", fused_encode, device),
            "encode_values_fused": ("fused_encode", fused_encode, device),
            "decode_tiles_fused": ("fused_decode", fused_decode, device),
            "bitshuffle_u32": ("bitshuffle", bitshuffle_kernel,
                               bitshuffle_kernel),
            "bitunshuffle_u32": ("bitshuffle", bitshuffle_kernel,
                                 bitshuffle_kernel)}


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
    engine's compress and decompress of both fields, both paths, of the
    v1 compress and decompress of the f32 field, and of a two-frame chain
    compress of the f32 field (advected)."""
    kept: dict[str, tuple] = {}
    real = {n: getattr(w[2], n) for n, w in WRAPPERS.items()}

    def wrap(name):
        def wrapped(*args):
            kept.setdefault(_signature(name, args), (name, args))
            return real[name](*args)
        return wrapped

    try:
        for n, w in WRAPPERS.items():
            setattr(w[2], n, wrap(n))
        for gen, shape, dtype in FIELDS:
            x = make_scientific_field(gen, shape, np.dtype(dtype), seed=0)
            for kw in ({}, {"preserve_order": False}):
                engine.decompress(engine.compress(x, 1e-2, **kw))
            if dtype == "float32":
                core.decompress(core.compress(x, 1e-2, container_version=1))
                temporal.compress_chain(make_field_sequence(
                    "advect", gen, shape, 2, np.dtype(dtype), seed=0), 1e-2)
    finally:
        for n, f in real.items():
            setattr(WRAPPERS[n][2], n, f)
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


def clock_breakdown(name: str, args, reps: int = 5,
                    defines: tuple = CLOCKS) -> dict:
    """Run one kept call through the clock build ``reps`` times."""
    lib_name, mod, _ = WRAPPERS[name]
    fn = getattr(mod, name)
    plain_ms = _device_ms(lambda: fn(*args), 20)
    real_call = _lib.call

    def clocked(lib, f, *a):
        return real_call(lib, f, *a, defines=defines)

    lib = _lib.library(lib_name, defines)
    lib.lopc_clock_names.restype = ctypes.c_char_p
    names = lib.lopc_clock_names().decode().split(",")
    sums = (ctypes.c_ulonglong * 16)()
    hits = (ctypes.c_ulonglong * 16)()
    _lib.call = clocked
    try:
        clocked_ms = _device_ms(lambda: fn(*args), 20)
        lib.lopc_clock_read(sums, hits)  # reset
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
        for d in VARIANTS.get(name, ()):
            res[d] = clock_breakdown(name, args, defines=CLOCKS + (d,))
        for label, r in [("", res)] + [(f" {d}", res[d])
                                        for d in VARIANTS.get(name, ())]:
            print(f"{sig}{label}: {r['ms']:.4f} ms ({r['clock_build_ms']:.4f} "
                  f"ms with clocks), {r['cta_cycles_per_launch']:.4g} "
                  "CTA-cycles per launch", flush=True)
            for s in r["slots"]:
                print(f"    {s['share']:.3f}  {s['phase']:<40} "
                      f"{s['cycles_per_hit']:10.1f} cycles x "
                      f"{s['hits_per_launch']:.0f}", flush=True)
    path = Path(_lib.BUILD_DIR).parents[1] / "chiprun_out" / "phase_clocks.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
