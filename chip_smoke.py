#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits nonzero before the last line is printed:

1. Set-up: the card's name and power limit; build the three CUDA kernels
   with nvcc (one process per source, in parallel).
2. Main path at full size, through the entry points a user calls: one
   ``repro_torch.engine.compress`` then ``decompress`` of a 100x500x500
   float32 field (the shape of one Hurricane ISABEL variable, made by the
   turbulence generator) and of a 256x384x384 float64 field (the Miranda
   shape, made by the gaussians generator), eb 1e-2 NOA.  Launch counts
   are zeroed just before each compress and each decompress and read just
   after; each path must have launched its kernels (compress: solve and
   encode; decompress: decode).  Checks the point-wise bound and that the
   decoded field keeps the strict SoS order of the input on every
   Freudenthal pair.  Then times a warm compress and decompress (median
   of 3) and profiles one of each (device time by kernel, the device's
   idle share).
   Independent checks of the same runs: the decoded values must equal,
   bit for bit, a whole-field reconstruction on the card that bypasses
   tiling, halo rounds, capacity batches, the streams and the container
   (quantize, order flags and a global Jacobi least fixed point of the
   subbins on the untiled field); the container decoded on the CPU must
   give the same values; and the f32 field compressed on the CPU must give
   the same container bytes.
3. Width runs: the same entry points on full-size fields at bounds that
   reach the int32 and int64 bins widths, and on 1-D and 2-D fields whose
   tiles are the (1,1,4096) and (1,64,64) plan tiles.
4. Kernels against their plain PyTorch versions on the card, on the very
   operands the runs above handed each kernel (recorded per signature):
   bit equality required.  Times each kernel by its device time per
   launch (torch.profiler) and the plain version with CUDA events, and
   computes each kernel's bound from the operands.
5. Determinism: the 24 snapshot cases of
   ``benchmarks/baselines/determinism_hashes.json`` compressed on the card
   must hash to the manifest (CPU <-> GPU byte identity) and round-trip
   within their bound.

Prints one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Imports neither jax nor repro.
"""
from __future__ import annotations

import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 bandwidth
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit peak, for integer ops
EB = 1e-2
ISABEL = ("turbulence", (100, 500, 500), "float32")
MIRANDA = ("gaussians", (256, 384, 384), "float64")

KERNELS = {
    "solve_tiles_blockwise": (
        "src/repro_torch/kernels/csrc/subbin_sweep.cu",
        "src/repro/kernels/subbin_sweep.py:148"),
    "encode_ints_fused": (
        "src/repro_torch/kernels/csrc/fused_encode.cu",
        "src/repro/kernels/fused_encode.py:110"),
    "decode_tiles_fused": (
        "src/repro_torch/kernels/csrc/fused_decode.cu",
        "src/repro/kernels/fused_decode.py:72"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------ recording

class Recorder:
    """Wraps the kernel wrappers the engine's device stages call, keeping
    the operands of the first calls per signature (the main path's real
    inputs) for the kernel-vs-plain phase."""

    def __init__(self, device_mod):
        self.calls: dict[tuple, list] = {}
        for attr in ("solve_tiles_blockwise", "encode_ints_fused",
                     "decode_tiles_fused"):
            real = getattr(device_mod, attr)
            setattr(device_mod, attr, self._wrap(attr, real))

    def _wrap(self, name, real):
        def wrapped(*args):
            key = (name,) + tuple(
                (tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") else a
                for a in args)
            kept = self.calls.setdefault(key, [])
            if len(kept) < 2:  # solve: round 1 and round 2 (live halos)
                kept.append(args)
            return real(*args)
        return wrapped


def cuda_ms(fn, reps: int) -> float:
    """Wall time per call on the card's clock (CUDA events around
    ``reps`` back-to-back calls): host gaps between launches count."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> tuple[float, int] | None:
    """Device time per launch of a wrapper that enqueues one kernel:
    the summed duration of the kernel events of ``reps`` calls in a
    torch.profiler trace over the number of events the trace holds (it
    may keep fewer than ``reps``), so host gaps between launches do not
    count.  Returns (ms, events), or None when the trace holds no
    kernel event."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()  # warm
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.key.startswith(("Activity Buffer", "Memcpy", "Memset"))]
    n = sum(ev.count for ev in kern)
    if not n:
        return None
    return sum(ev.self_device_time_total for ev in kern) / 1e3 / n, n


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    return float((a.long() - b.long()).abs().max().double()) if a.numel() else 0.0


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        idt = torch.int32 if a.element_size() == 4 else torch.int64
        return torch.equal(a.view(idt), b.view(idt))
    return torch.equal(a, b)


# --------------------------------------------------------------- checks

def order_preserved(x, y, topology) -> bool:
    """Strict SoS order of every in-grid Freudenthal pair is the same in
    ``x`` and ``y`` (CUDA tensors of one shape)."""
    import torch

    nd = x.dim()
    ones = torch.ones_like(x, dtype=torch.bool)
    for k, off in enumerate(topology.offsets(nd)):
        inside = topology.shift(ones, off, False)
        a = topology.sos_less(topology.shift(x, off, float("inf")), x, k, nd)
        b = topology.sos_less(topology.shift(y, off, float("inf")), y, k, nd)
        if not torch.equal(a & inside, b & inside):
            return False
    return True


def within_bound(x, y, eb) -> bool:
    import numpy as np

    bound = eb * (float(x.max()) - float(x.min()))
    return float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()) <= bound


# the kernels each path must launch
PATH_KERNELS = {"compress": ("solve_tiles_blockwise", "encode_ints_fused"),
                "decompress": ("decode_tiles_fused",)}


def main_path(name, shape, dtype, eng, executor, kernels, topology,
              make_field, launches: dict):
    """One full-size compress -> decompress through the entry points,
    checked: launches of each path's kernels, bound, strict SoS order on
    every Freudenthal pair.  ``launches`` gets the counts of each path,
    zeroed just before it and read just after."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    x = make_field(name, shape, np.dtype(dtype), seed=0)
    gen_s = time.perf_counter() - t0
    field = f"{name}{'x'.join(map(str, shape))}/{dtype}"
    executor.reset_transfer_counts()
    kernels.reset_launches()
    t0 = time.perf_counter()
    blob, stats = eng.compress(x, EB, return_stats=True)
    cold_c = time.perf_counter() - t0
    launches[f"{field} compress"] = dict(kernels.LAUNCHES)
    rounds = executor.TRANSFER_COUNTS["d2h_round"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    y = eng.decompress(blob)
    cold_d = time.perf_counter() - t0
    launches[f"{field} decompress"] = dict(kernels.LAUNCHES)
    for path, names in PATH_KERNELS.items():
        for k in names:
            check(launches[f"{field} {path}"].get(k, 0) > 0,
                  f"{k} never launched on the {field} {path} path")
    check(y.shape == x.shape and y.dtype == x.dtype, f"{name}: bad output shape")
    check(np.isfinite(y).all(), f"{name}: non-finite decode")
    check(within_bound(x, y, EB), f"{name}{shape}: point-wise bound violated")
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    check(order_preserved(xt, yt, topology), f"{name}{shape}: local order broken")
    return (x, blob, y), {
        "field": field,
        "raw_MB": x.nbytes / 1e6, "container_bytes": len(blob),
        "ratio": x.nbytes / len(blob), "cold_compress_s": cold_c,
        "cold_decompress_s": cold_d, "generate_s": gen_s,
        "halo_rounds": rounds, "n_sweeps": stats.n_sweeps,
    }


def whole_field_reference(x, eb):
    """The decoded field the engine must produce, computed on the card
    without tiles: bins by ``quantize_broadcast`` of the whole field, the
    order flags of the whole field, the least fixed point of the subbins
    by global Jacobi sweeps (``sub = max(sub, max_k[flag bit k](sub at
    offset k + tie_k))`` until nothing moves), then ``decode_base`` plus
    the subbin in ordered-int space.  Returns (values, sweeps)."""
    import torch

    from repro_torch.core import floatbits, quantize, topology

    xt = torch.from_numpy(x).cuda()
    eps = quantize.effective_eps(quantize.abs_bound_from_mode(x, eb, "noa"))
    bins = quantize.quantize_broadcast(xt, eps, xt.dtype)
    flags = topology.order_flags(bins, xt)
    offs, ties = topology.offsets(xt.dim()), topology.tie_breaker(xt.dim())
    need = [((flags >> k) & 1).bool() for k in range(len(offs))]
    del flags
    sub = torch.zeros(xt.shape, dtype=torch.int32, device=xt.device)
    sweeps = 0
    while True:
        before = sub
        for _ in range(16):  # one host sync per 16 sweeps
            new = sub
            for k, off in enumerate(offs):
                nb = topology.shift(sub, off, 0) + int(ties[k])
                new = torch.maximum(new, torch.where(need[k], nb, 0))
            sub = new
        sweeps += 16
        if torch.equal(before, sub):
            break
        check(sweeps <= xt.numel() + 16, "whole-field solve does not converge")
    base = quantize.decode_base(bins, eps, xt.dtype)
    y = floatbits.ordered_to_float(floatbits.float_to_ordered(base) + sub,
                                   xt.dtype)
    return y, sweeps


def full_size_agreement(x, blob, y, eng, info: dict, cpu_compress: bool) -> None:
    """Hold one full-size card run against computations that share none
    of its tiling, halo rounds, batching or device: the whole-field
    reconstruction on the card, the container decoded on the CPU and, if
    ``cpu_compress``, the field compressed on the CPU."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    y_ref, sweeps = whole_field_reference(x, EB)
    check(bits_equal(torch.from_numpy(y).cuda(), y_ref),
          f"{info['field']}: decoded values differ from the whole-field "
          "reconstruction")
    info.update(whole_field_sweeps=sweeps,
                whole_field_s=time.perf_counter() - t0)
    del y_ref
    t0 = time.perf_counter()
    y_cpu = eng.decompress(blob, device="cpu")
    info["cpu_decompress_s"] = time.perf_counter() - t0
    check(np.array_equal(y_cpu.view(f"i{y.itemsize}"), y.view(f"i{y.itemsize}")),
          f"{info['field']}: the CPU decodes the container to other values")
    if cpu_compress:
        t0 = time.perf_counter()
        blob_cpu = eng.compress(x, EB, device="cpu")
        info["cpu_compress_s"] = time.perf_counter() - t0
        check(blob_cpu == blob,
              f"{info['field']}: the CPU writes another container")
    log(f"full size {info['field']}: decoded values equal the whole-field "
        f"reconstruction ({sweeps} global sweeps) and the CPU decode"
        + ("; container equals the CPU's" if cpu_compress else ""))


def warm_timing(x, blob, y, eng, info: dict) -> None:
    """Warm compress and decompress, median of 3; every run must give the
    same bytes and values again."""
    import torch

    tc, td = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2 = eng.compress(x, EB)
        tc.append(time.perf_counter() - t0)
        check(b2 == blob, f"{info['field']}: compress not deterministic on the card")
        t0 = time.perf_counter()
        y2 = eng.decompress(b2)
        td.append(time.perf_counter() - t0)
        check(y2.tobytes() == y.tobytes(),
              f"{info['field']}: decompress not deterministic on the card")
    info.update(compress_MB_s=info["raw_MB"] / statistics.median(tc),
                decompress_MB_s=info["raw_MB"] / statistics.median(td),
                compress_s_runs=tc, decompress_s_runs=td)


def profile(name, shape, dtype, eng, make_field) -> dict:
    """Where one warm compress and one warm decompress spend their time:
    device time by kernel and memcpy (torch.profiler, CUPTI), the
    device's idle share of the wall time, and the host functions of the
    port by cumulative time (cProfile, a separate run: it slows Python
    code, so read its shares, not its seconds)."""
    import cProfile
    import pstats

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    x = make_field(name, shape, np.dtype(dtype), seed=0)
    blob = eng.compress(x, EB)
    out = {}
    for what, fn in (("compress", lambda: eng.compress(x, EB)),
                     ("decompress", lambda: eng.decompress(blob))):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for ev in prof.key_averages():
            # device-side events only (kernels, memcpy, memset); CPU ops
            # report their kernels' time again, and the activity-buffer
            # event is the profiler's own
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or ev.key.startswith("Activity Buffer")):
                continue
            rows.append((ev.self_device_time_total, ev.key, ev.count))
        rows.sort(reverse=True)
        # an empty device trace (CUPTI dropped the buffer) is not an idle
        # device: report it as not measured
        busy = sum(r[0] for r in rows) if rows else None
        host = cProfile.Profile()
        host.enable()
        fn()
        host.disable()
        stats = pstats.Stats(host).stats
        total = max(v[3] for v in stats.values())
        funcs = sorted(((v[3], f"{Path(k[0]).name}:{k[2]}")
                        for k, v in stats.items() if "repro_torch" in k[0]),
                       reverse=True)
        out[what] = {"wall_ms": wall_us / 1e3,
                     "device_busy_ms": None if busy is None else busy / 1e3,
                     "device_idle_share": None if busy is None else 1 - busy / wall_us,
                     "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": c}
                             for us, k, c in rows[:12]],
                     "host_cumulative_share": [
                         {"function": f, "share": cum / total}
                         for cum, f in funcs[:14]]}
    return out


# ---------------------------------------------------------- kernel phase

def bound_ms(name, args, out) -> tuple[float, str]:
    """Least time for this call's work: max(bytes / HBM rate, integer ops
    / peak rate), counting each input read once and each output written
    once, and the work this run's data needs."""
    import torch

    if name == "solve_tiles_blockwise":
        sub_h, flags = args
        res, iters = out
        nbytes = sub_h.nbytes + flags.nbytes + res.nbytes + iters.nbytes
        pop = sum(((flags >> k) & 1).reshape(flags.shape[0], -1).sum(1)
                  for k in range(14))
        # a set flag bit is an add and a max in every sweep the tile runs
        # (its changing sweeps plus the one that finds nothing to change)
        ops = float((2 * pop * (iters.long() + 1)).sum())
    elif name == "encode_ints_fused":
        ints = args[0]
        bitmap, words, counts = out
        nbytes = ints.nbytes + bitmap.nbytes + words.nbytes + counts.nbytes
        ops = float(words.numel() * words.element_size() * 8)  # one per bit
    else:
        bitmap, packed, sub_bitmap, sub_packed, eps = args[:5]
        read = sum(bm.nbytes + int((pk != 0).sum()) * pk.element_size()
                   for bm, pk in ((bitmap, packed), (sub_bitmap, sub_packed)))
        nbytes = read + eps.nbytes + out.nbytes
        ops = float(out.numel() * 8 * (packed.element_size()
                                       + sub_packed.element_size()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(rec, launches: dict):
    import torch

    from repro_torch.kernels import fused_decode, fused_encode, subbin_sweep

    impl = {
        "solve_tiles_blockwise": (subbin_sweep.solve_tiles_blockwise,
                                  subbin_sweep.solve_tiles_blockwise_plain),
        "encode_ints_fused": (fused_encode.encode_ints_fused,
                              fused_encode.encode_ints_plain),
        "decode_tiles_fused": (fused_decode.decode_tiles_fused,
                               fused_decode.decode_tiles_plain),
    }
    rows = []
    for name, (source, replaces) in KERNELS.items():
        kern, plain = impl[name]
        keys = [k for k in rec.calls if k[0] == name]
        check(keys, f"{name}: no recorded call")
        checks, err = [], 0.0
        for key in keys:
            for args in rec.calls[key]:
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
                same = all(bits_equal(a, b) for a, b in pairs)
                e = max(max_abs_err(a, b) for a, b in pairs)
                err = max(err, e)
                checks.append({"signature": repr(key[1:]), "match": same,
                               "max_abs_err": e})
                check(same, f"{name}: kernel differs from plain on {key[1:]} "
                            f"(max abs err {e})")
        # time the first signature recorded: the main path's f32 field
        key = keys[0]
        args = rec.calls[key][0]
        out = kern(*args)
        traced = device_ms(lambda: kern(*args), 20)
        if traced is None:  # the trace held no kernel event
            ms, timed_by = cuda_ms(lambda: kern(*args), 20), "CUDA events"
        else:
            ms, timed_by = traced[0], f"profiler device time, {traced[1]} launches"
        events_ms = cuda_ms(lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 1)
        b_ms, b_by = bound_ms(name, args, out)
        by_path = {p: c[name] for p, c in launches.items() if c.get(name)}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_timed_by": timed_by, "events_ms": events_ms,
            "match": True, "timed_signature": repr(key[1:]), "checks": checks,
        })
        log(f"kernel {name}: {len(checks)} checks bit-equal, {ms:.4f} ms "
            f"({timed_by}; {events_ms:.4f} ms by CUDA events around 20 "
            f"calls), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"on {key[1:]}; launches {by_path}")
    return rows


# ----------------------------------------------------------------- main

def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (SRC / "repro_torch" / "engine" / "engine.py").is_file():
        fail(f"the port's sources are not at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))

    import numpy as np

    from repro_torch import engine as eng
    from repro_torch import kernels
    from repro_torch.core import bitstream, topology
    from repro_torch.data.fields import FIELD_GENERATORS, make_scientific_field
    from repro_torch.engine import device as device_mod
    from repro_torch.engine import executor

    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules), "jax/repro imported")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build
    build_s = kernels.build()
    log(f"kernels built in {build_s:.1f} s")

    rec = Recorder(device_mod)
    field = functools.lru_cache(maxsize=None)(make_scientific_field)

    # ---- 2. main path at full size, each path's launches counted alone
    launches: dict[str, dict] = {}
    runs = [main_path(*cell, eng, executor, kernels, topology, field, launches)
            for cell in (ISABEL, MIRANDA)]
    log("main path launches: " + json.dumps(launches))
    results = []
    for arrays, info in runs:
        warm_timing(*arrays, eng, info)
        results.append(info)
    for r in results:
        log(f"full size {r['field']}: ratio {r['ratio']:.3f}, compress "
            f"{r['compress_MB_s']:.1f} MB/s, decompress {r['decompress_MB_s']:.1f} "
            f"MB/s (warm medians of 3), {r['halo_rounds']} halo rounds, "
            f"{r['n_sweeps']} sweeps; card {card}")
    log(json.dumps({"full_size": results, "main_path_launches": launches}))
    profiles = {cell[0]: profile(*cell, eng, field) for cell in (ISABEL, MIRANDA)}
    for cell, prof in profiles.items():
        for what, p in prof.items():
            busy = ("not measured (empty device trace)"
                    if p["device_busy_ms"] is None else
                    f"{p['device_busy_ms']:.1f} ms (idle share "
                    f"{p['device_idle_share']:.3f})")
            log(f"profile {cell} {what}: wall {p['wall_ms']:.1f} ms, device busy "
                f"{busy}; top: "
                + "; ".join(f"{t['kernel'][:40]} {t['ms']:.2f} ms x{t['calls']}"
                            for t in p["top"][:5]))
            log("  host (cProfile cumulative share): " + "; ".join(
                f"{h['function']} {h['share']:.2f}"
                for h in p["host_cumulative_share"][:10]))
    # independent checks of the main-path runs; only the f32 field is also
    # compressed on the CPU, whose plain sweeps take the f64 field's 45
    # halo rounds far more slowly than the card
    for (arrays, info), cpu_compress in zip(runs, (True, False)):
        full_size_agreement(*arrays, eng, info, cpu_compress)
    del runs

    # ---- 3. width and tile-shape runs (same entry points, not counted):
    # the full-size fields again at bounds that need int32 / int64 bins,
    # 1-D and 2-D fields on their plan tiles, and a strictly decreasing
    # run of 40000 floats inside one bin, whose subbins count down from
    # 39999 and so need the int32 subbin section
    n = 40000
    chain = (1.0 + (n - np.arange(n)) * 2.0**-23).astype(np.float32)
    widths = [(f"{ISABEL[0]}{ISABEL[1]}", field(*ISABEL[:2], np.dtype(ISABEL[2]), seed=0), 1e-6, "noa"),
              (f"{MIRANDA[0]}{MIRANDA[1]}", field(*MIRANDA[:2], np.dtype(MIRANDA[2]), seed=0), 1e-11, "noa"),
              ("waves(1048576,)", field("waves", (1 << 20,), np.dtype("float32"), seed=0), 1e-2, "noa"),
              ("front(2048, 2048)", field("front", (2048, 2048), np.dtype("float64"), seed=0), 1e-2, "noa"),
              ("decreasing-run(40000,)", chain, 1.0, "abs")]
    for label, x, eb, mode in widths:
        blob = eng.compress(x, eb, mode=mode)
        y = eng.decompress(blob)
        bound = eb if mode == "abs" else eb * (float(x.max()) - float(x.min()))
        err = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
        check(err <= bound, f"width run {label}@{eb}: bound violated")
        words = bitstream.read_container_v2(blob).stream_words()
        log(f"width run {label}/{x.dtype} eb {eb} {mode}: ratio "
            f"{x.nbytes / len(blob):.3f}, section words (bins, subbins) {words}")
    check(words[1] == 4, "the decreasing run did not reach int32 subbins")

    # ---- 4. kernels against plain versions on the recorded operands
    rows = kernel_phase(rec, launches)

    # ---- 5. determinism manifest on the card
    manifest = json.loads(
        (ROOT / "benchmarks" / "baselines" / "determinism_hashes.json").read_text())
    n = 0
    for name in sorted(FIELD_GENERATORS):
        for shape in ((13, 11, 9), (40, 28), (500,)):
            for dtype in ("float32", "float64"):
                case = f"{name}/{'x'.join(map(str, shape))}/{dtype}"
                x = make_scientific_field(name, shape, np.dtype(dtype), seed=5)
                blob = eng.compress(x, EB)
                check(hashlib.sha256(blob).hexdigest() == manifest[case],
                      f"{case}: container hash differs from the manifest")
                check(within_bound(x, eng.decompress(blob), EB),
                      f"{case}: round trip exceeds the bound")
                n += 1
    check(n == 24, "manifest cases missing")
    log(f"determinism: {n}/24 manifest hashes reproduced on the card")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "full_size": results,
         "profiles": profiles,
         "main_path_launches": launches, "kernels": rows}, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
