#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits nonzero before the last line is printed:

1. Set-up: the card's name and power limit; build the CUDA kernels with
   nvcc (one process per source, in parallel).
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
   the same container bytes.  Each compress on the card downloads its
   streams compacted (``encode_path="auto"``): its ``bytes_d2h`` must be
   at most 1.1x the container, and an ``encode_path="staged"`` compress
   (whose download ratio is printed beside) must give the same bytes.
2b. Plain path at full size: the same two fields through
   ``compress(..., preserve_order=False)`` and ``decompress``, launches
   counted per path as above (f32 compress: the fused value encode
   alone; f64 compress: the quantize stage and the integer encode; no
   solve; decompress: the decode kernel's no-subbin instantiation).
   Checks the bound, the compacted download, the staged bytes, values
   bit-equal to a whole-field plain reconstruction on the card
   (``quantize_broadcast`` then ``decode_base`` on the untiled field),
   and ISABEL's plain container byte-equal to the CPU path's.  Times a
   warm compress and decompress (median of 3) and profiles one of each
   (ISABEL's only).
2d. The whole-field (v1) compressor at full size: the same two fields
   through ``repro_torch.core.compress(x, 1e-2, container_version=1)``
   (``solver="auto"``: the band-solve kernel) and
   ``repro_torch.core.decompress``, launches counted per path (f32
   compress: the band solve, the BIT_4 transpose and the RZE bitmap
   twice each, for the bins and the subbins; f64 compress: the band
   solve alone, its 64-bit words run the torch codecs; f32 decompress:
   the inverse transpose twice; no v1 path launches a kernel of the tiled
   engine).  Checks the bound and the strict SoS order, that the v1
   decode equals the tiled engine's decode of the same field bit for bit
   (the parity claim) and the whole-field reconstruction, that the CPU
   decodes the v1 container to the same bits, and that ISABEL's v1
   sections, decoded and encoded again on the CPU with the plain
   versions, are the same bytes.  Times a warm compress and decompress
   (median of 3) and profiles one of each (ISABEL's only).
2c. Region reads: on the order-preserving container of each field and
   on ISABEL's plain one, ``decompress_roi`` of a box that straddles
   tile boundaries on every axis, a box inside one tile and a one-cell
   slab of full extent must equal the full decode's crop bit for bit and
   decode exactly ``tiles_for_region``'s tiles (``DECODE_COUNTS``); one
   ``decode_tiles_many`` over two containers must equal their
   single-container reads.  Times the boundary box against the full
   decompress.
2e. Topology-adaptive error bounds at full size: the same two fields
   through ``compress(..., adaptive_eb="tda")`` and ``decompress``,
   launches counted per path (ISABEL: the tile solve's 32-bit lane;
   Miranda: its 64-bit lane; both the integer encode; decompress: the
   decode kernel).  Checks strict SoS order (and the port's
   ``local_order_violations == 0``), ``critical_point_errors == (0, 0,
   0)``, every cell within its own tile's rung bound, logs the rung
   histogram and the ratio against the uniform container.  At eb 1e-2
   every tile of both fields takes the tightest rung, so Miranda runs a
   third time at eb 1e-3, where the ladder mixes rungs: at least two
   rungs must be taken and ``tighten_ladder`` must raise at least one
   (the mechanism itself, with cross-eps tile boundaries in the ordered
   lane).  For ISABEL and for the mixed run, a one-tile-deep cut (16 X
   rows) compressed adaptively on the card and on the CPU must give the
   same bytes, and the full container must decode on the CPU to the
   card's bits; so must Miranda's 16-row cut at eb 1e-2, uniform and
   adaptive (its real stream widths and the 64-bit lane).  Times a warm compress and decompress (median of 3) and
   profiles one of each (ISABEL's at eb 1e-2).
2f. The FF32 contract at full size: ISABEL at eps =
   ``effective_eps(1e-2 * range)``: ``ff32_domain_ok``, then
   ``kernels.ops.quantize_ff32`` -> ``core.subbin.solve_subbins`` (the
   band-solve kernel) -> ``dequantize_ff32``, exactly one launch each of
   the FF32 quantize and dequantize kernels; checks the bound, the local
   order and the critical points.
2g. Temporal chains at full size, through ``repro_torch.temporal``:
   isabel-f32-chain (6 ISABEL-shaped frames, turbulence advected, eb 1e-2
   NOA, keyframe interval 4: frames K R R R K R), miranda-f64-chain (4
   Miranda-shaped frames, gaussians diffused, interval 3) and
   isabel-f32-chain-adaptive (isabel's first 4 frames, interval 3,
   ``adaptive_eb="tda"``: the chain-wide ladder and the 32-bit ordered
   lane).  Frames are ``data.fields.make_field_sequence``'s, the base
   spectrum taken once per chain.  Launches are counted per path: the
   tile solve and kernel 2 must launch, kernel 2's zigzag at least once
   per residual frame (``kernels.TRANSFORM_LAUNCHES``), with one tile
   upload and one stream download per frame.  Every frame keeps the
   bound (adaptive: each tile's rung bound and no critical-point error)
   and the strict SoS order; a uniform chain's frames must equal the
   snapshot path's decode at the chain's bound
   (``engine.compress(frame, eps_abs, mode="abs")``), whose containers'
   sum is logged beside the chain's; ``decompress_frame(t)`` must equal
   the chain's decode and step only the frames from
   ``keyframe_before(t)``; a ``ChainDecoder`` stepped to frame k-1 must
   seed ``encode_appended_frame`` to the chain's own sections of frame k
   (one residual frame, one keyframe).  A cut of isabel's chain (4
   frames, interval 3, 16x256x256), uniform and adaptive, must give the
   CPU's bytes and decode.  Times one warm compress and decompress (raw
   MB of all frames), profiles one of each of the ISABEL chains (the
   host's shares of the first one's compress), and times the chain decode's torch stages
   on one frame beside kernel 3.
2h. The serving stack at full size (``repro_torch.store``,
   ``repro_torch.service``, ``repro_torch.obs``), launches counted per
   path (store, service: their own calls, not the references they are
   held to): a store (default plan, on the card) ``put``s
   phase 2's ISABEL container and ``write``s the field again (the same
   bytes); phase 2c's straddling box read cold must decode exactly its
   60 tiles and fetch under 5% of the payload file, read again from the
   tile cache must decode none, both equal to the full decode's crop; 3
   of phase 2g's ISABEL frames written as a chain and a 4th appended must
   equal ``compress_chain`` of the 4 frame by frame, and ``read_frame(3)``
   ``decompress_frame``; ``tests/data/make_fixtures.py``'s store calls
   replayed on the card must give ``tests/data/store/`` byte for byte.
   Then 8 client threads, released together, each compress ISABEL's
   first 100 - 10 i planes through the service, decompress the
   container and read a box of the stored field (clients 0-3 the box
   shifted by one tile, 4-7 the box itself): every container equals a
   direct compress, every decode the direct decompress, every box the
   full decode's crop, the mean batch occupancy exceeds 1 and no kernel
   library loads; the aggregate compress MB/s is logged beside the
   direct calls' (warm) and the latency percentiles.  Last, one traced
   service compress, decompress and box read of ISABEL and a ``python -m
   repro_torch.launch.serve --store --trace-out`` subprocess: both
   traces written to the run's output directory and validated against
   ``benchmarks/baselines/trace_schema.json`` in single mode, each
   ``exec.*`` stage's summed ms logged against ``engine.compress_group``.
2i. The sharded store cluster (``repro_torch.cluster``) on the card,
   launches counted per path (cluster write, read, chain: the cluster's
   own calls).  In process, a ``LocalCluster`` of 4 shards, 2 replicas,
   default plan: the router ``put``s phase 2's ISABEL container (each
   shard's sparse container must hold byte-verbatim sections of exactly
   its tiles, every tile on exactly 2 shards) and ``write``s the field
   (kernels 1 and 2; the same shard payloads); phase 2c's 60-tile box
   (kernel 3 in the workers) must equal the full decode's crop and a
   single store's read, the full read phase 2's decode; phase 2h's chain
   written with 3 frames and a 4th appended must leave the home
   replicas' payloads equal to phase 2h's store's and ``read_frame(3)``
   equal to its read; with the box's first tile's primary owner killed
   the box must come back equal, in 2 gather rounds, replicas serving
   tiles.  The box (healthy, degraded, and a single store's) and the
   full read are timed in separate passes, tile caches emptied before
   each; one traced box read, healthy and degraded, logs its spans'
   summed ms by name.  Over sockets, ``python -m repro_torch.launch.serve --cluster
   4 --trace-out``: it must exit 0 (its reads checked byte-identical to
   a single store, one worker SIGKILLed) and its trace validate against
   the schema in cluster mode from at least 2 processes; its read
   traces' spans are summed by name too.
2j. Distributed compression, the checkpoint and the baselines on the
   card, launches counted per path.  ``distributed.compress_fields_sharded``
   of ISABEL in this process over an NCCL group of world size 1 (a
   ``FileStore`` rendezvous; the sharded solve and its collectives on the
   card): its container must equal phase 2's, decode to phase 2's values,
   and its warm MB/s is logged beside phase 2's.  Then 2 gloo ranks, each
   a subprocess with its kernels on the one card (NCCL refuses two ranks
   on one GPU): both ranks' containers must equal phase 2's; their warm
   wall time is logged against phase 2's.  A ``CheckpointManager`` (async
   save, eb 1e-3 absolute) saves and restores ISABEL, a 64x384x384 slab of
   Miranda, a 4-D f32 leaf and int32 and bf16 leaves: lossy leaves within
   the bound, the others exact; a lossless save of the 4-D leaf and an
   ISABEL cut restores exactly; a small tree's leaf files written on the
   card must equal the CPU path's; save and restore MB/s logged.  The
   comparison codecs (``codecs.baselines``) on ISABEL at eb 1e-2 NOA:
   each codec's ratio beside LOPC's, with MB/s, the lossy ones within the
   bound, ``lossless_fp_decode`` exact, and each codec's blob on a cut
   equal to the CPU's.
2k. LM serving (``repro_torch.models``, ``python -m
   repro_torch.launch.serve --arch``).  (a) ``serve --arch qwen2.5-3b
   --requests 4 --prompt-len 48 --gen 16`` at the published config (36
   layers, d_model 2048, 16/2 heads, d_ff 11008, vocab 151936; 3.09 B f32
   parameters from seed 0, bf16 compute), once plain and once with
   ``--kv-quant``: finite logits of the right shapes; prefill seconds,
   decode tok/s, the run's peak device memory (above what earlier phases
   hold) and both runs' greedy tokens logged.
   (b) The card against the CPU, the same torch code in f32 compute with
   TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False`` for this
   comparison only): qwen2.5-3b at full width cut to 2 layers (with and
   without the int8 KV cache) and every other serving architecture at
   ``reduced_for_smoke``; prefill logits and caches and 2 decode steps
   (fed the CPU's greedy tokens), each case twice: with every cache
   store in f32, within 1e-4 * max(1, max|cpu|) with equal greedy
   tokens (the arithmetic alone); as served (bf16 K/V stores, or int8),
   within the CPU tests' bf16 tolerance 3e-2 (int8: 1e-2) and int8 codes
   one apart, since those stores turn the two matmuls' last-bit
   differences into whole steps that later layers carry.  (c) KV
   offload (``examples/serve_kv_compress_torch.py --full``): the full
   qwen's prefill caches, 72 K and V blocks of (4, 2*64*128), through
   ``CompressionService`` on the card at eb 1e-3 absolute on (16, 16, 64)
   tiles, launches counted around the service's compress and decompress
   ("kv C/D": kernels 1, 2 and 3 must launch); every block within the
   bound and equal to ``core.decompress`` of its container; 4 blocks'
   containers equal to the CPU's; the logit drift of 16 decode steps on
   restored K logged, and a profile of one warm decode step (device busy
   and idle share, top kernels, the host's shares).
3. Width runs: the same entry points on full-size fields at bounds that
   reach the int32 and int64 bins widths (ISABEL's also on the plain
   path), on 1-D and 2-D fields whose tiles are the (1,1,4096) and
   (1,64,64) plan tiles, an adaptive 1-D f64 field (the tile solve's
   64-bit lane on the 1-D tile, whose haloed state exceeds shared
   memory), and an adaptive f64 field whose subbin sections are 8 bytes
   wide (the encode and the decode kernel at w=64; its container must
   equal the CPU's), and a decreasing run of 40000 floats inside one bin
   (int32 subbin sections), whose container must hash to the reference's
   (``src/repro_torch/data/reference_hashes.json``).  Bounds within 2x of the smallest normal: a field
   of 4 * tiny * N(0, 1) cells at eb = 1.5 * tiny, f32 and f64,
   order-preserving and plain, and at eb = 4 * tiny, plain, must give
   the CPU's containers and decodes (the quantize and decode kernels
   flush subnormals as XLA does), and the FF32 pair at eps 1.5 * tiny
   must equal its plain version.  A
   64x64x256 field falling in linear index inside one bin (one chain
   through 4x4x4 tiles) must take four halo rounds or more, solve fewer
   tiles in its last round than in its first, keep the order and decode
   on the CPU to the same values; its round-1 and round-2 tile batches
   join phase 4.  Every compress logs the tiles solved per halo round.
4. Kernels against their plain PyTorch versions on the card, on the very
   operands the runs above handed each kernel (recorded per signature):
   bit equality required (the band solve: equal subbins and equal global
   sweep counts, on ISABEL's whole flags, on the first 32 X-rows of both
   fields' flags, on a 128x4x4 chain that descends in X, on an
   8x40x150 serpentine whose one chain winds through the whole Y x Z
   plane, on a 64x40x150 front that reaches one band more each
   global sweep, and on a chain of 8191 hops inside one tile, under the
   kernel's pass cap and under a cap of 8 passes, which must add
   launches; the tile solve on the round-1 and round-2 batches of each run,
   round 2 holding only the active tiles, the cross-tile ramp's among
   them; its ordered-space lanes on ISABEL-adaptive's batches (32-bit),
   Miranda-adaptive's and the 1-D f64 field's (64-bit); the FF32 pair at
   ISABEL's size and at eps 1.5 tiny).  The fused encode and decode
   (kernels 2, 3, 3') and kernel 4 also run adversarial operands
   (``fused_cases``): every pair of bins and subbin widths at f32 and
   f64, the 1-D and 2-D plan tiles, an odd tile, batch 1, an all-zero
   tile, bitmap rows with every bit set, words at the zigzag and wrap
   extremes; kernel 4 also the cells where its fast quantize and the
   reference's sequence meet (half-integer quotients and 1-2 ulps either
   side, exact bases, +-0, subnormal and non-finite cells, |q| near 2^30
   and 2^31), a tile per eps from 1e-6 to 1 and two TINY ones, at both
   store widths.  The BIT_4 transpose (kernel 8) runs 1, 2, 3 and 6104
   chunks of all-zero, all-one, single-bit, 0x80000000 and
   alternating-byte words (``bit4_cases``) both ways, and the two kernels
   in turn must give the words back.  Kernel 2 runs its cases with the
   delta, the raw and the zigzag transform, and the zigzag signatures
   the chains recorded.  Times each kernel by its device time per launch
   (torch.profiler) and the plain version with CUDA events, and computes
   each kernel's bound from the operands; those four kernels on every
   recorded signature.  The band
   solve is also timed on Miranda's whole flags (CUDA events, launches
   per global sweep), and each lane of the tile solve over every round of
   one main-path resident solve (CUDA events per round, with the round's
   tiles and bound).
5. Determinism: the 24 snapshot cases of
   ``benchmarks/baselines/determinism_hashes.json`` compressed on the card
   must hash to the manifest (CPU <-> GPU byte identity), and their
   plain containers to ``src/repro_torch/data/plain_hashes.json`` (the
   reference's plain containers), each with the default and with the
   fused encode path (the compacted download; on the plain f32 cases the
   fused value encode), and round-trip within their bound; their v1
   containers (the band-solve kernel on the card) must equal the CPU's
   (``jacobi``) byte for byte; the 8 ``adaptive/*`` cases, compressed
   under every solver value, must all hash to the manifest, and so must
   the 8 ``chain/*`` and 4 ``chain-adaptive/*`` chains, each frame
   within its bound.

Logs the seconds of each phase.  Prints one ``{"kernels": [...]}``
line, the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Imports neither jax nor repro.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
T0 = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 bandwidth
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit peak, for integer ops
F64_OPS_PER_S = 34e12         # H100 SXM non-tensor f64 peak
F32_OPS_PER_S = 67e12         # H100 SXM non-tensor f32 peak
D2H_CEILING = 1.1             # compress download / container bytes
EB = 1e-2
# Miranda's adaptive run at this bound mixes rungs (at EB every tile of
# both fields takes the tightest) and makes tighten_ladder raise rungs
EB_MIXED = 1e-3
ISABEL = ("turbulence", (100, 500, 500), "float32")
MIRANDA = ("gaussians", (256, 384, 384), "float64")

KERNELS = {
    "solve_tiles_blockwise": (
        "src/repro_torch/kernels/csrc/subbin_sweep.cu",
        "src/repro/kernels/subbin_sweep.py:148"),
    # the same kernel on the adaptive path's ordered-space state: f32
    # fields run its int32 instantiation, f64 fields its int64 one
    "solve_tiles_blockwise_ordered32": (
        "src/repro_torch/kernels/csrc/subbin_sweep.cu",
        "src/repro/kernels/subbin_sweep.py:148"),
    "solve_tiles_blockwise_64": (
        "src/repro_torch/kernels/csrc/subbin_sweep.cu",
        "src/repro/kernels/subbin_sweep.py:148"),
    "encode_ints_fused": (
        "src/repro_torch/kernels/csrc/fused_encode.cu",
        "src/repro/kernels/fused_encode.py:110"),
    "decode_tiles_fused": (
        "src/repro_torch/kernels/csrc/fused_decode.cu",
        "src/repro/kernels/fused_decode.py:72"),
    "encode_values_fused": (
        "src/repro_torch/kernels/csrc/fused_encode.cu",
        "src/repro/kernels/fused_encode.py:142"),
    # kernel 3 without a subbin stream: the plain containers' decode,
    # an XLA chain in the reference (engine/device.py:680)
    "decode_tiles_fused_nosub": (
        "src/repro_torch/kernels/csrc/fused_decode.cu",
        "src/repro/kernels/fused_decode.py:72"),
    "solve_blockwise": (
        "src/repro_torch/kernels/csrc/subbin_sweep.cu",
        "src/repro/kernels/subbin_sweep.py:212"),
    "bitshuffle_u32": (
        "src/repro_torch/kernels/csrc/bitshuffle.cu",
        "src/repro/kernels/bitshuffle_kernel.py:64"),
    "bitunshuffle_u32": (
        "src/repro_torch/kernels/csrc/bitshuffle.cu",
        "src/repro/kernels/bitshuffle_kernel.py:68"),
    "rze_bitmap_u32": (
        "src/repro_torch/kernels/csrc/rze.cu",
        "src/repro/kernels/rze_kernel.py:34"),
    "quantize_ff32": (
        "src/repro_torch/kernels/csrc/ff32.cu",
        "src/repro/kernels/quantize_kernel.py:33"),
    "dequantize_ff32": (
        "src/repro_torch/kernels/csrc/ff32.cu",
        "src/repro/kernels/fused_decode.py:140"),
}
# the LAUNCHES counter of a row, where it is not the row's name, and
# which paths' counts belong to the row
COUNTER = {"solve_tiles_blockwise_ordered32": "solve_tiles_blockwise"}


def row_paths(name: str, path: str) -> bool:
    if name == "solve_tiles_blockwise":
        return "adaptive" not in path
    if name == "solve_tiles_blockwise_ordered32":
        return "adaptive" in path
    return True
TILED_KERNELS = ("solve_tiles_blockwise", "encode_ints_fused",
                 "decode_tiles_fused", "encode_values_fused")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:.0f} s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------ recording

class Recorder:
    """Wraps the kernel wrappers the engine's device stages call, keeping
    the operands of the first calls per signature (the main path's real
    inputs) for the kernel-vs-plain phase."""

    def __init__(self, device_mod, v1_mods, ff32_mods):
        self.calls: dict[tuple, list] = {}
        self.real: dict[str, object] = {}
        # set while an adaptive path runs: its int32 tile solves are the
        # ordered-space lane, recorded apart from the subbin lane's
        self.ordered = False
        # a label that keeps a run's tile solves apart from the others'
        self.tag = ""
        # the tile solve's round within the running resident solve, and
        # the first resident solve's operands per lane and tag
        self.solve_round = 0
        self.solves: dict[tuple, tuple] = {}
        targets = [(device_mod, a) for a in TILED_KERNELS] + [
            (v1_mods[0], "solve_blockwise"), (v1_mods[1], "bitshuffle_u32"),
            (v1_mods[1], "bitunshuffle_u32"), (v1_mods[2], "rze_bitmap_u32"),
            (ff32_mods[0], "quantize_ff32"), (ff32_mods[1], "dequantize_ff32")]
        for mod, attr in targets:
            self.real[attr] = getattr(mod, attr)
            setattr(mod, attr, self._wrap(attr, getattr(mod, attr)))
        self.real["resident_solve"] = device_mod.resident_solve
        device_mod.resident_solve = self._wrap_solve(device_mod.resident_solve)

    def lane(self, state) -> str:
        if state is not None and state.element_size() == 8:
            return "solve_tiles_blockwise_64"
        return ("solve_tiles_blockwise_ordered32" if self.ordered
                else "solve_tiles_blockwise")

    def _wrap_solve(self, real):
        def wrapped(flags, idx, mask, max_rounds, adjacency, sub0=None,
                    n_real=None, **sharded):
            self.solve_round = 0
            if not sharded:  # a sharded batch's block is not replayed
                self.solves.setdefault((self.lane(sub0), self.tag), (
                    flags, idx, mask, max_rounds, adjacency,
                    None if sub0 is None else sub0.clone(), n_real))
            return real(flags, idx, mask, max_rounds, adjacency=adjacency,
                        sub0=sub0, n_real=n_real, **sharded)
        return wrapped

    def _wrap(self, name, real):
        def wrapped(*args):
            kname = name
            extra = ()
            if name == "decode_tiles_fused" and args[2] is None:
                # a decode without subbin arrays is its own kernel
                kname = "decode_tiles_fused_nosub"
            elif name == "solve_tiles_blockwise":
                kname = self.lane(args[0])
                self.solve_round += 1
                if self.solve_round > 2:  # round 1 and round 2 (live halos)
                    return real(*args)
                # the batch of round 2 holds only the active tiles
                extra = (self.tag, f"round {self.solve_round}")
            shapes = tuple(
                (tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") else a
                for a in args)
            if extra:  # one key for every batch size
                shapes = tuple((sh[1:], dt) for sh, dt in shapes)
            kept = self.calls.setdefault((kname,) + extra + shapes, [])
            if len(kept) < 2:
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


def queued_ms(fn, reps: int) -> float:
    """Device time per call of a wrapper that enqueues kernels without a
    host sync: CUDA events around ``reps`` back-to-back calls queued
    behind a spin kernel (``torch.cuda._sleep``) that outlasts the host's
    enqueueing, so the host's time between launches does not count.  The
    fallback where a profiler trace holds no kernel event."""
    import torch

    fn()  # warm
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


def device_ms(fn, reps: int, kernel: str = "") -> tuple[float, int] | None:
    """Device time per launch of a wrapper that enqueues one kernel:
    the summed duration of the kernel events of ``reps`` calls in a
    torch.profiler trace over the number of events the trace holds (it
    may keep fewer than ``reps``), so host gaps between launches do not
    count.  With ``kernel``, only events whose name holds it count.
    Returns (ms, events), or None when the trace holds no such event."""
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
            and not ev.key.startswith(("Activity Buffer", "Memcpy", "Memset"))
            and kernel in ev.key]
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


# the kernels each path must launch, and those it must not
PATH_KERNELS = {"compress": ("solve_tiles_blockwise", "encode_ints_fused"),
                "decompress": ("decode_tiles_fused",)}
PLAIN_KERNELS = {
    ("compress", "float32"): (("encode_values_fused",),
                              ("solve_tiles_blockwise", "encode_ints_fused")),
    ("compress", "float64"): (("encode_ints_fused",),
                              ("solve_tiles_blockwise", "encode_values_fused")),
    ("decompress", "float32"): (("decode_tiles_fused_nosub",),
                                ("decode_tiles_fused",)),
    ("decompress", "float64"): (("decode_tiles_fused_nosub",),
                                ("decode_tiles_fused",)),
}


def download_ratio(x, blob, counts: dict, eng, executor, info: dict,
                   **kw) -> None:
    """The compress that wrote ``blob`` (its ``TRANSFER_COUNTS`` in
    ``counts``) downloaded its streams compacted: at most ``D2H_CEILING``
    x the container.  A staged compress of the same field must give the
    same bytes; its download ratio is recorded beside, and so is the
    ratio word-level compaction alone would have given."""
    ratio = counts["bytes_d2h"] / len(blob)
    check(ratio <= D2H_CEILING,
          f"{info['field']}: compress downloaded {ratio:.4f}x the container "
          f"(ceiling {D2H_CEILING})")
    executor.reset_transfer_counts()
    staged = eng.compress(x, EB, encode_path="staged", **kw)
    check(staged == blob, f"{info['field']}: the staged encode path writes "
                          "another container")
    word_form = counts["bytes_d2h"] + counts.get("bytes_d2h_byte_level_saved", 0)
    info.update(d2h_ratio=ratio,
                word_form_d2h_ratio=word_form / len(blob),
                staged_d2h_ratio=executor.TRANSFER_COUNTS["bytes_d2h"] / len(blob))


def solved_tiles(field: str) -> list:
    """The tiles the last compress's resident solve gathered and solved
    in each halo round (round 1: every real tile; later rounds: the
    tiles whose halo reads a tile that moved), logged."""
    from repro_torch.engine import device as device_mod

    solved = list(device_mod.SOLVED_TILES[-1])
    log(f"{field} compress: tiles solved per halo round {solved}")
    return solved


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
    counts = dict(executor.TRANSFER_COUNTS)
    solved = solved_tiles(field)
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
    info = {
        "field": field,
        "raw_MB": x.nbytes / 1e6, "container_bytes": len(blob),
        "ratio": x.nbytes / len(blob), "cold_compress_s": cold_c,
        "cold_decompress_s": cold_d, "generate_s": gen_s,
        "halo_rounds": rounds, "n_sweeps": stats.n_sweeps,
        "solved_tiles_per_round": solved,
    }
    download_ratio(x, blob, counts, eng, executor, info)
    return (x, blob, y), info


def plain_path(name, shape, dtype, eng, executor, kernels, make_field,
               launches: dict):
    """Phase 2b: one full-size plain compress -> decompress through the
    entry points; each path's launches counted alone and checked against
    ``PLAIN_KERNELS``; bound, compacted download and staged bytes."""
    import numpy as np

    x = make_field(name, shape, np.dtype(dtype), seed=0)
    field = f"{name}{'x'.join(map(str, shape))}/{dtype} plain"
    executor.reset_transfer_counts()
    kernels.reset_launches()
    t0 = time.perf_counter()
    blob = eng.compress(x, EB, preserve_order=False)
    cold_c = time.perf_counter() - t0
    launches[f"{field} compress"] = dict(kernels.LAUNCHES)
    counts = dict(executor.TRANSFER_COUNTS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    y = eng.decompress(blob)
    cold_d = time.perf_counter() - t0
    launches[f"{field} decompress"] = dict(kernels.LAUNCHES)
    for (path, dt), (need, never) in PLAIN_KERNELS.items():
        if dt != dtype:
            continue
        got = launches[f"{field} {path}"]
        for k in need:
            check(got.get(k, 0) > 0, f"{k} never launched on the {field} {path} path")
        for k in never:
            check(got.get(k, 0) == 0, f"{k} launched on the {field} {path} path")
    check(y.shape == x.shape and y.dtype == x.dtype, f"{field}: bad output shape")
    check(np.isfinite(y).all(), f"{field}: non-finite decode")
    check(within_bound(x, y, EB), f"{field}: point-wise bound violated")
    info = {"field": field, "raw_MB": x.nbytes / 1e6,
            "container_bytes": len(blob), "ratio": x.nbytes / len(blob),
            "cold_compress_s": cold_c, "cold_decompress_s": cold_d}
    download_ratio(x, blob, counts, eng, executor, info, preserve_order=False)
    return (x, blob, y), info


def plain_reference(x, eb):
    """The decoded field a plain container must give, on the card without
    tiles: ``quantize_broadcast`` of the whole field, then ``decode_base``
    and the ordered-int round trip with a zero subbin."""
    import torch

    from repro_torch.core import floatbits, quantize

    xt = torch.from_numpy(x).cuda()
    eps = quantize.effective_eps(quantize.abs_bound_from_mode(x, eb, "noa"))
    bins = quantize.quantize_broadcast(xt, eps, xt.dtype)
    base = quantize.decode_base(bins, eps, xt.dtype)
    return floatbits.ordered_to_float(floatbits.float_to_ordered(base),
                                      xt.dtype)


def plain_agreement(x, blob, y, eng, info: dict, cpu_compress: bool) -> None:
    """Phase 2b's independent checks: the whole-field plain reconstruction
    on the card and, if ``cpu_compress``, the CPU path's container."""
    import torch

    check(bits_equal(torch.from_numpy(y).cuda(), plain_reference(x, EB)),
          f"{info['field']}: decoded values differ from the whole-field "
          "plain reconstruction")
    if cpu_compress:
        t0 = time.perf_counter()
        blob_cpu = eng.compress(x, EB, preserve_order=False, device="cpu")
        info["cpu_compress_s"] = time.perf_counter() - t0
        check(blob_cpu == blob, f"{info['field']}: the CPU writes another "
                                "container")
    log(f"full size {info['field']}: decoded values equal the whole-field "
        "plain reconstruction"
        + ("; container equals the CPU's" if cpu_compress else ""))


# per (path, dtype): {kernel: launches required (None: at least one)};
# every other kernel must not launch on a v1 path
V1_KERNELS = {
    ("compress", "float32"): {"solve_blockwise": None, "bitshuffle_u32": 2,
                              "rze_bitmap_u32": 2},
    ("compress", "float64"): {"solve_blockwise": None},
    ("decompress", "float32"): {"bitunshuffle_u32": 2},
    ("decompress", "float64"): {},
}


def v1_path(name, shape, dtype, core, kernels, topology, make_field,
            launches: dict, y_tiled):
    """Phase 2d: one full-size whole-field (v1) compress -> decompress
    through ``repro_torch.core``; each path's launches counted alone and
    checked against ``V1_KERNELS``; bound, strict SoS order, the decode
    bit-equal to the tiled engine's decode ``y_tiled`` of the same field
    (the parity claim) and to the CPU's decode of the container."""
    import numpy as np
    import torch

    x = make_field(name, shape, np.dtype(dtype), seed=0)
    field = f"{name}{'x'.join(map(str, shape))}/{dtype} v1"
    kernels.reset_launches()
    t0 = time.perf_counter()
    blob, stats = core.compress(x, EB, container_version=1, return_stats=True)
    cold_c = time.perf_counter() - t0
    launches[f"{field} compress"] = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    y = core.decompress(blob)
    cold_d = time.perf_counter() - t0
    launches[f"{field} decompress"] = dict(kernels.LAUNCHES)
    for (path, dt), need in V1_KERNELS.items():
        if dt != dtype:
            continue
        got = launches[f"{field} {path}"]
        for k, n in need.items():
            check(got.get(k, 0) > 0 if n is None else got.get(k, 0) == n,
                  f"{k} launched {got.get(k, 0)} times on the {field} {path} "
                  f"path (want {'>= 1' if n is None else n})")
        for k in set(got) - set(need):
            check(got[k] == 0, f"{k} launched on the {field} {path} path")
    check(blob[4] == 1, f"{field}: not a v1 container")
    check(y.shape == x.shape and y.dtype == x.dtype, f"{field}: bad output shape")
    check(np.isfinite(y).all(), f"{field}: non-finite decode")
    check(within_bound(x, y, EB), f"{field}: point-wise bound violated")
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    check(order_preserved(xt, yt, topology), f"{field}: local order broken")
    del xt, yt
    check(y.tobytes() == y_tiled.tobytes(),
          f"{field}: the v1 decode differs from the tiled engine's decode")
    t0 = time.perf_counter()
    y_cpu = core.decompress(blob, device="cpu")
    cpu_d = time.perf_counter() - t0
    check(y_cpu.tobytes() == y.tobytes(),
          f"{field}: the CPU decodes the v1 container to other values")
    info = {"field": field, "raw_MB": x.nbytes / 1e6,
            "container_bytes": len(blob), "ratio": x.nbytes / len(blob),
            "bin_bytes": stats.bin_bytes, "subbin_bytes": stats.subbin_bytes,
            "n_sweeps": stats.n_sweeps, "cold_compress_s": cold_c,
            "cold_decompress_s": cold_d, "cpu_decompress_s": cpu_d}
    log(f"full size {field}: decode equals the tiled engine's and the CPU's "
        f"decode; {stats.n_sweeps} global band sweeps")
    return (x, blob, y), info


def v1_sections_reencode(blob, info: dict) -> None:
    """The card's v1 sections, decoded and encoded again on the CPU with
    the plain versions (BIT_4, RZE bitmap, compaction), are the same
    bytes: the f32 kernels against their plain versions at full size,
    without a CPU solve."""
    import torch

    from repro_torch.codecs import pipeline
    from repro_torch.core import bitstream

    t0 = time.perf_counter()
    header, sections = bitstream.read_container(blob)
    n = 1
    for d in header.shape:
        n *= d
    for tag, dec, enc in ((bitstream.TAG_BINS, pipeline.decode_bins,
                           pipeline.encode_bins),
                          (bitstream.TAG_SUBBINS, pipeline.decode_subbins,
                           pipeline.encode_subbins)):
        ints = dec(sections[tag], n, header.shape, torch.int32, device="cpu")
        check(enc(ints) == sections[tag],
              f"{info['field']}: section {tag} encodes to other bytes on the CPU")
    info["cpu_reencode_s"] = time.perf_counter() - t0
    log(f"full size {info['field']}: bins and subbin sections re-encode "
        "byte-identically on the CPU")


# per (path, dtype): (kernels each adaptive path must launch, kernels it
# must not): f32 fields run the tile solve's 32-bit lane, f64 its 64-bit
ADAPTIVE_KERNELS = {
    ("compress", "float32"): (("solve_tiles_blockwise", "encode_ints_fused"),
                              ("solve_tiles_blockwise_64",)),
    ("compress", "float64"): (("solve_tiles_blockwise_64", "encode_ints_fused"),
                              ("solve_tiles_blockwise",)),
    ("decompress", "float32"): (("decode_tiles_fused",), ()),
    ("decompress", "float64"): (("decode_tiles_fused",), ()),
}


def within_rung_bounds(x, y, c, eng) -> bool:
    """Every cell within its own tile's rung bound, the rule of the
    reference's tests/test_order_properties.py: ``eb * range * 2**(k_max
    - rung)`` (the header holds the loosest rung, ``eb * range *
    2**k_max``), with a slack of 64 ulps of the dtype.  ``c`` is the
    parsed container (a v2 snapshot's, or a v3 chain's for any frame)."""
    import numpy as np
    import torch

    from repro_torch.tda.adaptive import tile_ids

    layout = eng.container_layout(c)
    rung = torch.from_numpy(c.eb_ladder().astype(np.int64)).cuda()
    tile_bound = c.header.eps_abs * torch.exp2(-rung.double())
    bound = (tile_bound[tile_ids(layout, rung.device)].reshape(x.shape)
             * (1 + 64 * float(np.finfo(x.dtype).eps)))
    err = (torch.from_numpy(x).cuda().double()
           - torch.from_numpy(y).cuda().double()).abs()
    return bool((err <= bound).all())


def adaptive_path(name, shape, dtype, eng, executor, kernels, topology, tda,
                  make_field, launches: dict, rec, uniform_blob, eb=EB,
                  mixed=False):
    """Phase 2e: one full-size adaptive compress -> decompress through the
    entry points; each path's launches counted alone and checked against
    ``ADAPTIVE_KERNELS``; strict SoS order, no critical-point error, every
    cell within its tile's rung bound.  ``mixed``: the ladder must take
    two rungs or more, and ``tighten_ladder`` must raise a rung."""
    import numpy as np
    import torch

    from repro_torch.core import bitstream
    from repro_torch.tda import adaptive

    x = make_field(name, shape, np.dtype(dtype), seed=0)
    field = f"{name}{'x'.join(map(str, shape))}/{dtype} adaptive"
    if eb != EB:
        field += f" eb {eb}"
    raised = []
    tighten = adaptive.tighten_ladder

    def spy(x_, layout, ladder, *a, **kw):
        out = tighten(x_, layout, ladder, *a, **kw)
        raised.append(int((out > np.asarray(ladder)).sum()))
        return out

    executor.reset_transfer_counts()
    kernels.reset_launches()
    rec.ordered = True
    adaptive.tighten_ladder = spy
    t0 = time.perf_counter()
    try:
        blob, stats = eng.compress(x, eb, adaptive_eb="tda", return_stats=True)
    finally:
        adaptive.tighten_ladder = tighten
    cold_c = time.perf_counter() - t0
    rec.ordered = False
    launches[f"{field} compress"] = dict(kernels.LAUNCHES)
    rounds = executor.TRANSFER_COUNTS["d2h_round"]
    solved = solved_tiles(field)
    kernels.reset_launches()
    t0 = time.perf_counter()
    y = eng.decompress(blob)
    cold_d = time.perf_counter() - t0
    launches[f"{field} decompress"] = dict(kernels.LAUNCHES)
    for (path, dt), (need, never) in ADAPTIVE_KERNELS.items():
        if dt != dtype:
            continue
        got = launches[f"{field} {path}"]
        for k in need:
            check(got.get(k, 0) > 0, f"{k} never launched on the {field} {path} path")
        for k in never:
            check(got.get(k, 0) == 0, f"{k} launched on the {field} {path} path")
    check(y.shape == x.shape and y.dtype == x.dtype, f"{field}: bad output shape")
    check(np.isfinite(y).all(), f"{field}: non-finite decode")
    check(within_rung_bounds(x, y, bitstream.read_container_v2(blob), eng),
          f"{field}: a cell exceeds its tile's rung bound")
    t0 = time.perf_counter()
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    check(order_preserved(xt, yt, topology), f"{field}: local order broken")
    lov = tda.local_order_violations(xt, yt)
    check(lov == 0, f"{field}: {lov} local order violations")
    cpe = tda.critical_point_errors(xt, yt)
    check(cpe == (0, 0, 0), f"{field}: critical point errors {cpe}")
    checks_s = time.perf_counter() - t0
    del xt, yt
    c = bitstream.read_container_v2(blob)
    rungs = np.bincount(c.eb_ladder(), minlength=bitstream.EB_LADDER_K_MAX + 1)
    check(len(raised) == 1, f"{field}: the ladder was scored {len(raised)} times")
    if mixed:
        check(int((rungs > 0).sum()) >= 2, f"{field}: the ladder takes one "
              f"rung only ({rungs.tolist()})")
        check(raised[0] > 0, f"{field}: tighten_ladder raised no rung")
    info = {"field": field, "eb": eb, "raw_MB": x.nbytes / 1e6,
            "container_bytes": len(blob), "ratio": x.nbytes / len(blob),
            "ratio_vs_uniform": len(uniform_blob) / len(blob),
            "rungs": rungs.tolist(), "tighten_raised": raised[0],
            "section_words": list(c.stream_words()),
            "halo_rounds": rounds, "n_sweeps": stats.n_sweeps,
            "solved_tiles_per_round": solved,
            "cold_compress_s": cold_c, "cold_decompress_s": cold_d,
            "topology_checks_s": checks_s}
    log(f"full size {field}: rungs (loosest first) {rungs.tolist()} "
        f"({raised[0]} raised by tighten_ladder), ratio "
        f"{info['ratio']:.3f} = {info['ratio_vs_uniform']:.4f}x the uniform "
        f"container's; section words {c.stream_words()}; order kept, "
        f"critical point errors {cpe}, every cell within its rung bound")
    return (x, blob, y), info


def cut_agreement(x, eng, info: dict, **kw) -> None:
    """A one-tile-deep cut of the field (16 X-rows) compressed on the card
    and on the CPU (with ``kw``: adaptive or not) gives the same bytes."""
    import numpy as np

    cut = np.ascontiguousarray(x[:16])
    eb = info.get("eb", EB)
    t0 = time.perf_counter()
    blob_cut = eng.compress(cut, eb, **kw)
    check(eng.compress(cut, eb, device="cpu", **kw) == blob_cut,
          f"{info['field']}: the 16-row cut's container differs on the CPU")
    info["cpu_cut_compress_s"] = time.perf_counter() - t0
    log(f"full size {info['field']}: the {cut.shape} cut's container equals "
        f"the CPU's ({len(blob_cut)} bytes, {info['cpu_cut_compress_s']:.1f} s)")


def adaptive_cpu_agreement(x, blob, y, eng, info: dict) -> None:
    """The 16-row cut's adaptive container equals the CPU's; the full
    container decodes on the CPU to the card's bits."""
    cut_agreement(x, eng, info, adaptive_eb="tda")
    t0 = time.perf_counter()
    y_cpu = eng.decompress(blob, device="cpu")
    info["cpu_decompress_s"] = time.perf_counter() - t0
    check(y_cpu.tobytes() == y.tobytes(),
          f"{info['field']}: the CPU decodes the container to other values")
    log(f"full size {info['field']}: the CPU decodes the full container to "
        "the card's bits")


def ff32_path(name, shape, dtype, ops, subbin, quantize, tda, kernels,
              make_field, launches: dict) -> dict:
    """Phase 2f: the FF32 contract at full size through
    ``repro_torch.kernels.ops``: quantize -> subbin solve -> dequantize,
    each FF32 kernel launched once; bound, local order, critical points."""
    import numpy as np
    import torch

    x = make_field(name, shape, np.dtype(dtype), seed=0)
    field = f"{name}{'x'.join(map(str, shape))}/{dtype} ff32"
    xt = torch.from_numpy(x).cuda()
    eb_abs = EB * (float(x.max()) - float(x.min()))
    eps = np.float32(quantize.effective_eps(eb_abs))
    check(ops.ff32_domain_ok(xt, eps), f"{field}: outside the FF32 domain")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bins = ops.quantize_ff32(xt, eps)
    sub, sweeps = subbin.solve_subbins(bins, xt)
    y = ops.dequantize_ff32(bins, sub, eps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(kernels.LAUNCHES)
    launches[field] = got
    for k, n in (("quantize_ff32", 1), ("dequantize_ff32", 1)):
        check(got.get(k, 0) == n, f"{k} launched {got.get(k, 0)} times on "
                                  f"the {field} path (want {n})")
    check(got.get("solve_blockwise", 0) > 0, f"solve_blockwise never launched "
                                             f"on the {field} path")
    err = float((xt.double() - y.double()).abs().max())
    check(err <= eb_abs, f"{field}: error {err} exceeds the bound {eb_abs}")
    lov = tda.local_order_violations(xt, y)
    check(lov == 0, f"{field}: {lov} local order violations")
    cpe = tda.critical_point_errors(xt, y)
    check(cpe == (0, 0, 0), f"{field}: critical point errors {cpe}")
    info = {"field": field, "eps32": float(eps), "max_err": err,
            "bound": eb_abs, "sweeps": sweeps, "wall_s": wall,
            "launches": got}
    log(f"full size {field}: max error {err:.6g} <= {eb_abs:.6g}, order kept, "
        f"critical point errors {cpe}, {sweeps} band sweeps, {wall:.3f} s")
    return info


# ---- 2g: temporal chains
#
# (cell, evolution, base, shape, dtype, frames, keyframe interval,
# compress keywords): isabel's frames run K R R R K R, miranda's K R R K;
# the adaptive cell takes isabel's first 4 frames
CHAIN_CELLS = (
    ("isabel-f32-chain", "advect", *ISABEL, 6, 4, {}),
    ("miranda-f64-chain", "diffuse", *MIRANDA, 4, 3, {}),
    ("isabel-f32-chain-adaptive", "advect", *ISABEL, 4, 3,
     {"adaptive_eb": "tda"}),
)
# the isabel chain's cut compressed on the card and on the CPU: its first
# 4 frames at interval 3, 16 X-rows (one tile deep), Y and Z cut to 256
CHAIN_CUT = (slice(0, 16), slice(0, 256), slice(0, 256))
def chain_frames(evolution, base, shape, dtype, n_frames: int,
                 make_field) -> list:
    """``fields.make_field_sequence(evolution, base, shape, n_frames,
    dtype, seed=0)`` from the base field of ``make_field`` (the main
    path's cached ``make_scientific_field``, whose f64 field is
    miranda's base)."""
    import numpy as np

    from repro_torch.data import fields

    x0 = make_field(base, shape, np.dtype("float64"), seed=0)
    return fields.sequence_from_base(evolution, x0, n_frames, np.dtype(dtype))


def frame_kinds(n: int, interval: int) -> list:
    from repro_torch.core import bitstream

    return [bitstream.FRAME_KEY if t == 0 or (interval and t % interval == 0)
            else bitstream.FRAME_RESIDUAL for t in range(n)]


def chain_path(label, frames, interval, kw, temporal, eng, executor, kernels,
               topology, tda, launches: dict, rec):
    """Phase 2g: one full-size chain compress -> decompress through
    ``repro_torch.temporal``, each path's launches counted alone: the tile
    solve and kernel 2, with the zigzag at least once per residual frame;
    one tile upload and one stream download per frame.  Every frame keeps
    the bound (adaptive: each tile's rung bound, no critical-point error)
    and the strict SoS order; a uniform chain's frames equal the snapshot
    path's decode at the chain's bound; ``decompress_frame`` equals the
    chain's decode and replays from the keyframe before; appended frames
    give the chain's own sections."""
    import numpy as np
    import torch

    from repro_torch.core import bitstream

    adaptive = bool(kw)
    n = len(frames)
    kinds = frame_kinds(n, interval)
    n_res = kinds.count(bitstream.FRAME_RESIDUAL)
    raw_mb = sum(f.nbytes for f in frames) / 1e6
    executor.reset_transfer_counts()
    kernels.reset_launches()
    rec.ordered = adaptive
    t0 = time.perf_counter()
    blob, stats = temporal.compress_chain(frames, EB, keyframe_interval=interval,
                                          return_stats=True, **kw)
    cold_c = time.perf_counter() - t0
    rec.ordered = False
    launches[f"{label} compress"] = dict(kernels.LAUNCHES)
    by_transform = dict(kernels.TRANSFORM_LAUNCHES)
    counts = dict(executor.TRANSFER_COUNTS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    y = temporal.decompress_chain(blob)
    cold_d = time.perf_counter() - t0
    launches[f"{label} decompress"] = dict(kernels.LAUNCHES)
    got = launches[f"{label} compress"]
    for k in ("solve_tiles_blockwise", "encode_ints_fused"):
        check(got.get(k, 0) > 0, f"{k} never launched on the {label} compress path")
    zig = by_transform.get("encode_ints_fused_zigzag", 0)
    check(zig >= n_res, f"{label}: {zig} zigzag encodes for {n_res} residual frames")
    check(counts["h2d_tiles"] == n and counts["d2h_sections"] == n,
          f"{label}: {counts['h2d_tiles']} tile uploads and "
          f"{counts['d2h_sections']} stream downloads for {n} frames")
    c = bitstream.read_container_v3(blob)
    check([e.kind for e in c.entries] == kinds, f"{label}: frame kinds differ")
    check(y.shape == (n,) + frames[0].shape and y.dtype == frames[0].dtype,
          f"{label}: bad output shape")
    t0 = time.perf_counter()
    for t, x in enumerate(frames):
        check(np.isfinite(y[t]).all(), f"{label} frame {t}: non-finite decode")
        if adaptive:
            check(within_rung_bounds(x, y[t], c, eng),
                  f"{label} frame {t}: a cell exceeds its tile's rung bound")
        else:
            err = float(np.abs(x.astype(np.float64) - y[t].astype(np.float64)).max())
            check(err <= stats.eps_abs, f"{label} frame {t}: error {err} exceeds "
                                        f"the chain's bound {stats.eps_abs}")
        xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y[t]).cuda()
        check(order_preserved(xt, yt, topology), f"{label} frame {t}: local order broken")
        if adaptive:
            lov = tda.local_order_violations(xt, yt)
            cpe = tda.critical_point_errors(xt, yt)
            check(lov == 0 and cpe == (0, 0, 0), f"{label} frame {t}: {lov} "
                  f"local order violations, critical point errors {cpe}")
        del xt, yt
    checks_s = time.perf_counter() - t0
    # the per-frame snapshot containers at the chain's own bound (the
    # chain's user bound, with a ladder per frame, when adaptive)
    t0 = time.perf_counter()
    snap_bytes = 0
    for t, x in enumerate(frames):
        if adaptive:
            s = eng.compress(x, c.header.eps_abs * 2.0**-bitstream.EB_LADDER_K_MAX,
                             mode="abs", adaptive_eb="tda")
        else:
            s = eng.compress(x, stats.eps_abs, mode="abs")
            check(eng.decompress(s).tobytes() == y[t].tobytes(),
                  f"{label} frame {t}: the chain's decode differs from the "
                  "snapshot path's at the chain's bound")
        snap_bytes += len(s)
    snapshot_s = time.perf_counter() - t0
    random_access(blob, y, c, temporal, label)
    appended_frames(frames, (kinds.index(bitstream.FRAME_RESIDUAL), interval),
                    c, temporal, label, adaptive)
    info = {"field": label, "frames": n, "keyframe_interval": interval,
            "kinds": "".join("K" if k == bitstream.FRAME_KEY else "R" for k in kinds),
            "raw_MB": raw_mb, "container_bytes": len(blob),
            "ratio": raw_mb * 1e6 / len(blob),
            "snapshot_bytes": snap_bytes, "ratio_vs_snapshots": snap_bytes / len(blob),
            "bins_bytes": stats.bins_bytes, "subbin_bytes": stats.subbin_bytes,
            "eps_abs": stats.eps_abs, "n_sweeps": stats.n_sweeps,
            "zigzag_launches": zig, "launches_by_transform": by_transform,
            "transfers": counts, "cold_compress_s": cold_c,
            "cold_decompress_s": cold_d, "frame_checks_s": checks_s,
            "snapshot_s": snapshot_s}
    if adaptive:
        info["rungs"] = np.bincount(c.eb_ladder(),
                                    minlength=bitstream.EB_LADDER_K_MAX + 1).tolist()
    log(f"full size {label} ({info['kinds']}): ratio {info['ratio']:.3f}, "
        f"{info['ratio_vs_snapshots']:.4f}x smaller than its {n} snapshot "
        f"containers ({snap_bytes} bytes against {len(blob)}); {zig} zigzag "
        f"encodes for {n_res} residual frames; every frame within its bound, "
        "order kept"
        + (", no critical point error" if adaptive else
           ", equal to the snapshot path's decode")
        + "; decompress_frame and appended frames agree")
    return blob, y, info


def random_access(blob, y, c, temporal, label: str) -> None:
    """``decompress_frame(t)`` equals the chain's decode of frame t and
    steps the bins of the frames from ``keyframe_before(t)`` to t only."""
    steps = []
    real = temporal.ChainDecoder.step

    def counted(self, t):
        steps.append(t)
        return real(self, t)

    temporal.ChainDecoder.step = counted
    try:
        for t in range(c.n_frames):
            steps.clear()
            got = temporal.decompress_frame(blob, t)
            check(got.tobytes() == y[t].tobytes(),
                  f"{label}: decompress_frame({t}) differs from the chain's decode")
            check(steps == list(range(c.keyframe_before(t), t + 1)),
                  f"{label}: decompress_frame({t}) stepped frames {steps}")
    finally:
        temporal.ChainDecoder.step = real


def appended_frames(frames, ks, c, temporal, label: str,
                    adaptive: bool) -> None:
    """A ``ChainDecoder`` stepped to frame k-1 seeds
    ``encode_appended_frame`` with its resident bins: frame k's sections
    must be the chain's own, for each k of ``ks`` (ascending; one decoder
    steps on through them)."""
    import numpy as np

    from repro_torch.core import bitstream
    from repro_torch.core.quantize import effective_eps

    dec = temporal.ChainDecoder(c)
    eps_tight = effective_eps(c.header.eps_abs) * (
        2.0**-bitstream.EB_LADDER_K_MAX if adaptive else 1.0)
    for k in ks:
        for j in range(dec.pos + 1, k):
            dec.step(j)
        prev_max = float(np.max(np.abs(frames[k - 1]))) / eps_tight + 4
        sections, _, _, _ = temporal.encode_appended_frame(
            frames[k], eps_abs=c.header.eps_abs, kind=c.entries[k].kind,
            prev_bins=dec.resident_bins(), prev_max_bin=prev_max,
            ladder=c.eb_ladder() if adaptive else None)
        check(sections == c.frame_tiles(k)[0],
              f"{label}: the appended frame {k} differs from the chain's sections")


def chain_cut_agreement(frames, temporal, info: dict) -> None:
    """``CHAIN_CUT`` of the isabel chain's first 4 frames at interval 3,
    uniform and adaptive, compressed on the card and on the CPU: the
    same bytes, and the CPU decodes them to the card's values."""
    import numpy as np

    cut = [np.ascontiguousarray(f[CHAIN_CUT]) for f in frames[:4]]
    t0 = time.perf_counter()
    for kw in ({}, {"adaptive_eb": "tda"}):
        blob = temporal.compress_chain(cut, EB, keyframe_interval=3, **kw)
        check(temporal.compress_chain(cut, EB, keyframe_interval=3,
                                      device="cpu", **kw) == blob,
              f"the {cut[0].shape} chain cut {kw}: the CPU writes another chain")
        check(temporal.decompress_chain(blob, device="cpu").tobytes()
              == temporal.decompress_chain(blob).tobytes(),
              f"the {cut[0].shape} chain cut {kw}: the CPU decodes other values")
    info["cpu_chain_cut_s"] = time.perf_counter() - t0
    log(f"chain cut {cut[0].shape} x 4 frames, uniform and adaptive: the "
        f"card's chains equal the CPU's ({info['cpu_chain_cut_s']:.1f} s)")


def chain_timing(frames, interval, kw, blob, y, temporal, info: dict,
                 reps: int) -> None:
    """Warm ``compress_chain`` and ``decompress_chain``, median of
    ``reps``, in raw MB/s; every run gives the same bytes and values
    again."""
    import torch

    tc, td = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2 = temporal.compress_chain(frames, EB, keyframe_interval=interval, **kw)
        tc.append(time.perf_counter() - t0)
        check(b2 == blob, f"{info['field']}: compress not deterministic on the card")
        t0 = time.perf_counter()
        y2 = temporal.decompress_chain(b2)
        td.append(time.perf_counter() - t0)
        check(y2.tobytes() == y.tobytes(),
              f"{info['field']}: decompress not deterministic on the card")
    info.update(compress_MB_s=info["raw_MB"] / statistics.median(tc),
                decompress_MB_s=info["raw_MB"] / statistics.median(td),
                compress_s_runs=tc, decompress_s_runs=td)


def chain_decode_stages(blob, temporal, card: str) -> dict:
    """The chain decode's torch stages on a full-size frame, by CUDA
    events: a keyframe's and a residual frame's bins (the torch decode of
    ``device.decode_tiles``, the residual's accumulate), the subbins and
    the dequantize; beside them kernel 3 on the keyframe's bins and
    subbins, the same work as one kernel."""
    import numpy as np
    import torch

    from repro_torch.core import bitstream
    from repro_torch.engine import device as device_mod
    from repro_torch.kernels import fused_decode

    c = bitstream.read_container_v3(blob)
    dec = temporal.ChainDecoder(c)
    dec.step(0)
    e = dec.layout.tile_elems
    tiles, _ = c.frame_tiles(0)
    streams = [dec._upload_sections(sec, temporal.chain._section_word(sec[0]))
               for sec in ([b for b, _ in tiles], [s for _, s in tiles])]
    key = dec.bins
    res_tiles, _ = c.frame_tiles(1)
    res_sec = [b for b, _ in res_tiles]
    res = dec._upload_sections(res_sec, temporal.chain._section_word(res_sec[0]))
    subs = device_mod.decode_tiles(*streams[1], e, "raw", streams[1][0].dtype)
    eps = torch.full((dec.capacity,), dec.eps_eff, dtype=torch.float64,
                     device=key.device)
    dtype = torch.float64 if dec.dtype == np.float64 else torch.float32
    out = {
        "keyframe_bins_ms": cuda_ms(lambda: device_mod.decode_tiles(
            *streams[0], e, "delta", dec.bdt), 5),
        "residual_bins_ms": cuda_ms(lambda: device_mod.accumulate_bins(
            key, device_mod.decode_tiles(*res, e, "zigzag", dec.bdt)), 5),
        "subbins_ms": cuda_ms(lambda: device_mod.decode_tiles(
            *streams[1], e, "raw", streams[1][0].dtype), 5),
        "dequantize_ms": cuda_ms(lambda: device_mod.dequantize_tiles(
            key, subs, eps, dtype), 5),
        "kernel3_keyframe_ms": cuda_ms(lambda: fused_decode.decode_tiles_fused(
            *streams[0], *streams[1], eps, e, dtype), 20),
        "tiles": dec.layout.n_tiles, "capacity": dec.capacity, "card": card,
    }
    log(f"chain decode stages ({dec.capacity} tiles of {e}, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items()
                    if k.endswith("_ms")) + f"; card {card}")
    return out


# ---- 2h: the serving stack
#
# clients 0-3 of the service read phase 2c's straddling box shifted by
# one (16, 16, 64) tile, clients 4-7 the box itself (a hot region)
BOX_SHIFTS = ((16, 0, 0), (0, 16, 0), (0, 0, 64), (16, 16, 64))
SERVE_CLIENTS = 8
# the store's region read must fetch under this share of its payload file
ROI_BYTES_SHARE = 0.05


def _shifted(region, shift):
    return tuple(slice(sl.start + d, sl.stop + d) for sl, d in zip(region, shift))


def _single_mode_schema() -> dict:
    """``benchmarks/baselines/trace_schema.json`` as
    ``benchmarks/check_trace.py --mode single`` reads it: the cluster's
    names dropped."""
    schema = json.loads(
        (ROOT / "benchmarks" / "baselines" / "trace_schema.json").read_text())
    cluster = ("router.", "lprc.", "worker.")
    schema["require_names"] = [n for n in schema.get("require_names", [])
                               if not n.startswith(cluster)]
    schema["nest_under"] = {k: v for k, v in schema.get("nest_under", {}).items()
                            if not k.startswith(cluster + ("router",))}
    return schema


def _store_payload(store, name: str) -> bytes:
    return (store.root / store.info(name)["payload"]).read_bytes()


def store_path(store, x, blob, y, frames, eng, executor, kernels,
               temporal) -> tuple[dict, dict]:
    """Phase 2h, the store: ``put`` phase 2's isabel container, ``write``
    the field again (same bytes), the straddling box read cold (exactly
    its tiles decoded, under 5% of the payload file read) and cached (no
    decode), both equal to the full decode's crop; a 3-frame chain
    written, a 4th appended, its frames equal to ``compress_chain`` of the
    4 and ``read_frame(3)`` to ``decompress_frame``; the committed
    fixture's calls replayed on the card, byte for byte.  Returns the
    timings and the launches of the store's own calls: the references
    (``compress_chain``, ``decompress_frame``) run after the count is read;
    and the chain's payload file, bound and ``read_frame(3)``, which phase
    2i holds the cluster's replicas to."""
    import numpy as np

    from repro_torch.core import bitstream
    from repro_torch.core.quantize import abs_bound_from_mode
    from repro_torch.data.fields import make_field_sequence, make_scientific_field
    from repro_torch.engine.plan import CompressionPlan
    from repro_torch.store import LopcStore

    box = ROI_REGIONS["straddle"]
    info = {}
    ids = eng.tiles_for_region(
        eng.container_layout(bitstream.read_container_v2(blob)), box)
    crop = np.ascontiguousarray(y[box]).tobytes()
    # a chain of 3 frames, then a 4th appended: one absolute bound that
    # is every frame's NOA bound or tighter, so the chain of 4 pins it too
    eb_abs = min(abs_bound_from_mode(f, EB, "noa") for f in frames[:4])
    data = ROOT / "tests" / "data"
    fx_root = store.root.parent / "fixture"
    kernels.reset_launches()
    store.put("isabel-put", blob)
    check(_store_payload(store, "isabel-put") == blob,
          "store.put changed the container's bytes")
    t0 = time.perf_counter()
    store.write("isabel", x, EB)
    info["write_s"] = time.perf_counter() - t0
    check(_store_payload(store, "isabel") == blob,
          "store.write's payload differs from phase 2's container")
    executor.reset_decode_counts()
    t0 = time.perf_counter()
    cold = store.read_roi("isabel", box)
    info["roi_cold_s"] = time.perf_counter() - t0
    check(executor.DECODE_COUNTS["tiles"] == len(ids) == 60,
          f"the store's cold read decoded {executor.DECODE_COUNTS['tiles']} "
          f"tiles, the box needs {len(ids)}")
    nread = store._readers["isabel"][2].bytes_read
    info["roi_bytes_read"], info["payload_bytes"] = nread, len(blob)
    check(nread < ROI_BYTES_SHARE * len(blob),
          f"the store's cold read fetched {nread} of {len(blob)} payload bytes")
    executor.reset_decode_counts()
    t0 = time.perf_counter()
    cached = store.read_roi("isabel", box)
    info["roi_cached_s"] = time.perf_counter() - t0
    check(executor.DECODE_COUNTS["tiles"] == 0, "the cached read decoded tiles")
    check(cold.tobytes() == crop and cached.tobytes() == crop,
          "the store's region reads differ from the full decode's crop")

    t0 = time.perf_counter()
    store.write_chain("isabel-chain", frames[:3], eb_abs, mode="abs")
    info["write_chain_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(store.append_frame("isabel-chain", frames[3]) == 3,
          "append_frame gave another frame index")
    info["append_frame_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = store.read_frame("isabel-chain", 3)
    info["read_frame_s"] = time.perf_counter() - t0

    # the committed fixture's calls (tests/data/make_fixtures.py)
    fx = LopcStore.create(fx_root, plan=CompressionPlan(tile_shape=(8, 8, 8)))
    fx.write("snap", make_scientific_field("front", (12, 11, 10), np.float32,
                                           seed=24), EB)
    sframes = make_field_sequence("diffuse", "waves", (10, 9, 8), 3,
                                  np.float32, seed=25)
    fx.write_chain("evolution", sframes[:2], 1e-1, mode="abs",
                   keyframe_interval=2)
    fx.append_frame("evolution", sframes[2])
    fx_snap, fx_chain = fx.read("snap"), fx.read("evolution")
    fx.close()
    launches = dict(kernels.LAUNCHES)

    whole = temporal.compress_chain(frames[:4], eb_abs, mode="abs")
    c3 = bitstream.read_container_v3(whole)
    payload = _store_payload(store, "isabel-chain")
    entries = store.info("isabel-chain")["frames"]
    check(len(entries) == 4 and all(
        payload[e["off"]:e["off"] + e["len"]] == c3.frame_payload(t)
        for t, e in enumerate(entries)),
        "the stored chain's frames differ from compress_chain of the 4 frames")
    check(got.tobytes() == temporal.decompress_frame(whole, 3).tobytes(),
          "read_frame(3) differs from decompress_frame")
    want = np.load(data / "expected.npz")
    check(fx_snap.tobytes() == want["store_snap"].tobytes()
          and fx_chain.tobytes() == want["store_chain"].tobytes(),
          "the fixture's reads on the card differ from expected.npz")
    for rel in ("manifest.json", "payload/snap.lopc", "payload/evolution.frames"):
        check((fx.root / rel).read_bytes() == (data / "store" / rel).read_bytes(),
              f"the card's store fixture differs from tests/data/store/{rel}")
    log(f"2h store: write {info['write_s']:.2f} s (= phase 2's bytes); box "
        f"cold {info['roi_cold_s'] * 1e3:.1f} ms ({len(ids)} tiles, {nread} of "
        f"{len(blob)} payload bytes), cached {info['roi_cached_s'] * 1e3:.2f} ms; "
        f"chain of 3 written {info['write_chain_s']:.2f} s, 4th appended "
        f"{info['append_frame_s']:.2f} s (= compress_chain), read_frame(3) "
        f"{info['read_frame_s']:.2f} s; fixture replayed byte for byte")
    return info, launches, {"payload": payload, "eb_abs": eb_abs, "frame3": got}


def service_path(store, x, y, eng, kernels, card: str) -> tuple[dict, dict]:
    """Phase 2h, the service: 8 client threads, released together, each
    compress ``x[:100 - 10 i]``, decompress their container and read a
    box of the stored field (clients 0-3 one tile off phase 2c's box, 4-7
    the box itself).  Every container equals a direct compress, every
    decode the direct decompress, every box the full decode's crop; the
    mean batch occupancy exceeds 1 and no library loads.  Returns the
    timings and the service's own launches: the direct calls it is held
    to run outside the count."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch.service import CompressionService, ServiceConfig

    box = ROI_REGIONS["straddle"]
    arrays = [x[: 100 - 10 * i] for i in range(SERVE_CLIENTS)]
    boxes = [_shifted(box, BOX_SHIFTS[i]) if i < len(BOX_SHIFTS) else box
             for i in range(SERVE_CLIENTS)]
    raw_mb = sum(a.nbytes for a in arrays) / 1e6

    def direct_pass():
        blobs, secs = [], []
        for a in arrays:
            t0 = time.perf_counter()
            blobs.append(eng.compress(a, EB))
            secs.append(time.perf_counter() - t0)
        return blobs, secs

    # the first pass meets each slab's tile grid for the first time; the
    # one timed against the service runs after it, warm like the service
    direct, cold_s = direct_pass()
    store.cache.clear()
    start = threading.Barrier(SERVE_CLIENTS + 1)
    t_start = [0.0]

    def client(i):
        start.wait()
        blob = svc.submit_compress(arrays[i], EB).result()
        t_c = time.perf_counter() - t_start[0]
        return blob, t_c, svc.submit_decompress(blob).result(), \
            svc.submit_store_roi(store, "isabel", boxes[i]).result()

    traces0 = eng.device.trace_count()
    kernels.reset_launches()
    with CompressionService(ServiceConfig(max_delay_ms=20.0)) as svc:
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            futs = [pool.submit(client, i) for i in range(SERVE_CLIENTS)]
            t_start[0] = time.perf_counter()
            start.wait()
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t_start[0]
        m = svc.metrics()
    launches = dict(kernels.LAUNCHES)
    again, direct_s = direct_pass()
    check(again == direct, "direct compresses not deterministic on the card")
    for i, (blob, _, yi, roi) in enumerate(results):
        check(blob == direct[i], f"service client {i}: container differs from "
              "a direct engine.compress")
        check(yi.tobytes() == eng.decompress(direct[i]).tobytes(),
              f"service client {i}: decode differs from engine.decompress")
        check(within_bound(arrays[i], yi, EB), f"service client {i}: bound")
        check(roi.tobytes() == np.ascontiguousarray(y[boxes[i]]).tobytes(),
              f"service client {i}: store box differs from the full decode's crop")
    check(m.failed == 0 and m.completed == 3 * SERVE_CLIENTS,
          f"service: {m.completed} completed, {m.failed} failed")
    check(m.mean_batch_occupancy > 1,
          f"service batches held {m.mean_batch_occupancy:.2f} requests on average")
    check(m.traces_added == 0 and eng.device.trace_count() == traces0,
          "service traffic loaded a kernel library")
    t_compress = max(r[1] for r in results)
    info = {"clients": SERVE_CLIENTS, "raw_MB": raw_mb,
            "service_compress_MB_s": raw_mb / t_compress,
            "direct_compress_MB_s": raw_mb / sum(direct_s),
            "direct_compress_s": direct_s, "direct_first_pass_s": cold_s,
            "wall_s": wall,
            "p50_ms": m.p50_ms, "p99_ms": m.p99_ms, "batches": m.batches,
            "mean_batch_occupancy": m.mean_batch_occupancy,
            "max_batch_occupancy": m.max_batch_occupancy,
            "device_groups": m.device_groups,
            "mean_device_group_occupancy": m.mean_device_group_occupancy,
            "cache_hits": m.cache_hits, "cache_misses": m.cache_misses,
            "traces_added": m.traces_added}
    log(f"2h service: {SERVE_CLIENTS} clients, {raw_mb:.0f} MB; compress "
        f"{info['service_compress_MB_s']:.1f} MB/s aggregate vs "
        f"{info['direct_compress_MB_s']:.1f} MB/s direct (one after another, "
        f"warm; first pass {raw_mb / sum(cold_s):.1f}); "
        f"latency p50 {m.p50_ms:.1f} ms, p99 {m.p99_ms:.1f} ms; {m.batches} "
        f"batches, occupancy mean {m.mean_batch_occupancy:.2f} / max "
        f"{m.max_batch_occupancy}; tile cache {m.cache_hits} hits / "
        f"{m.cache_misses} misses; {wall:.2f} s wall; card {card}")
    return info, launches


def trace_path(store, x, blob, y, out_dir: Path) -> dict:
    """Phase 2h, the trace: one traced service compress, decompress and
    store box read of the full field, written to ``out_dir`` and
    validated in single mode; each ``exec.*`` stage's summed ms beside
    ``engine.compress_group``'s; then ``python -m
    repro_torch.launch.serve --store --trace-out`` as a subprocess, its
    trace validated too."""
    import os

    from repro_torch import obs
    from repro_torch.service import CompressionService, ServiceConfig

    schema = _single_mode_schema()
    store.cache.clear()
    obs.tracer().drain()
    obs.enable()
    try:
        with CompressionService(ServiceConfig()) as svc:
            t0 = time.perf_counter()
            b = svc.compress(x, EB)
            traced_s = time.perf_counter() - t0
            yt = svc.decompress(b)
            svc.store_roi(store, "isabel", ROI_REGIONS["straddle"])
        spans = obs.tracer().drain()
    finally:
        obs.disable()
    check(b == blob and yt.tobytes() == y.tobytes(),
          "tracing changed the service's bytes or values")
    doc = obs.write_trace(str(out_dir / "chip_smoke_trace.json"), spans,
                          meta={"mode": "chip_smoke phase 2h"})
    errors = obs.validate_trace(doc, schema)
    check(not errors, f"the service trace fails the schema: {errors[:3]}")
    by_id = {s.span_id: s for s in spans}

    def group_of(s):
        while s is not None and not s.name.startswith("engine."):
            s = by_id.get(s.parent_id)
        return s

    stage_ms: dict[str, float] = {}
    for s in spans:
        g = group_of(s) if s.name.startswith("exec.") else None
        if g is not None and g.name == "engine.compress_group":
            stage_ms[s.name] = stage_ms.get(s.name, 0.0) + s.dur_us / 1e3
    group_ms = sum(s.dur_us for s in spans
                   if s.name == "engine.compress_group") / 1e3
    check(group_ms > 0 and stage_ms, "the traced compress has no stage spans")

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--store",
           "--clients", "4", "--requests-per-client", "2",
           "--trace-out", str(out_dir / "serve_store_trace.json")]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    serve_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"serve --store failed ({proc.returncode}): {proc.stderr[-2000:]}")
    serve_doc = json.loads((out_dir / "serve_store_trace.json").read_text())
    errors = obs.validate_trace(serve_doc, schema)
    check(not errors, f"serve --store's trace fails the schema: {errors[:3]}")
    info = {"traced_compress_s": traced_s, "compress_group_ms": group_ms,
            "exec_stage_ms": stage_ms, "n_spans": len(spans),
            "serve_store_s": serve_s, "serve_store_spans": len(serve_doc["spans"]),
            "serve_store_stdout": proc.stdout.strip().splitlines()}
    log("2h trace: " + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(stage_ms.items()))
        + f" of engine.compress_group {group_ms:.1f} ms ("
        f"{sum(stage_ms.values()) / group_ms:.2f}); traced compress "
        f"{traced_s:.2f} s; serve --store {serve_s:.1f} s, "
        f"{info['serve_store_spans']} spans, valid")
    for line in info["serve_store_stdout"]:
        log(f"  serve --store | {line}")
    return info


def serving_phase(x, blob, y, frames, eng, executor, kernels, temporal,
                  launches: dict, card: str) -> tuple[dict, dict]:
    """Phase 2h: the store, the service and the trace, each path's
    launches counted alone (zeroed just before its own calls, read just
    after them; the references it is held to run outside).  Returns the
    timings and the store's chain (see ``store_path``)."""
    import shutil

    from repro_torch.store import LopcStore

    root = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(root, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    store = LopcStore.create(root / "isabel")
    try:
        info = {}
        info["store"], launches["store"], chain = store_path(
            store, x, blob, y, frames, eng, executor, kernels, temporal)
        info["service"], launches["service"] = service_path(
            store, x, y, eng, kernels, card)
        info["trace"] = trace_path(store, x, blob, y, out_dir)
    finally:
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    for path, need in (("store", ("solve_tiles_blockwise", "encode_ints_fused",
                                  "decode_tiles_fused")),
                       ("service", ("solve_tiles_blockwise", "encode_ints_fused",
                                    "decode_tiles_fused"))):
        for k in need:
            check(launches[path].get(k, 0) > 0, f"{k} never launched on the {path} path")
    return info, chain


# ---- 2i: the sharded store cluster
#
# the in-process rig: 4 shards on the card, each tile range on 2 of them
CLUSTER_SHARDS = 4
CLUSTER_REPLICAS = 2
# timing passes of each cluster read, each after the tile caches are
# emptied (the checked call before them is not timed)
CLUSTER_REPS = 3
_SERVE_READS = re.compile(r"healthy ([0-9.]+)s, after SIGKILL of shard "
                          r"(\d+) ([0-9.]+)s")


def _cluster_payloads(cl, name: str) -> dict:
    return {i: _store_payload(w.store, name) for i, w in enumerate(cl.workers)
            if name in w.store.names()}


def _span_ms(spans) -> dict:
    """Summed ms by span name (span objects or their dicts)."""
    out: dict[str, float] = {}
    for sp in spans:
        d = sp if isinstance(sp, dict) else sp.as_dict()
        out[d["name"]] = out.get(d["name"], 0.0) + d["dur_us"] / 1e3
    return dict(sorted(out.items()))


def _traced_read(obs, read, stores) -> tuple:
    """One ``read()`` with tracing on, the tile caches emptied before ->
    (its result, its spans)."""
    for st in stores:
        st.cache.clear()
    obs.tracer().drain()
    obs.enable()
    try:
        out = read()
        return out, obs.tracer().drain()
    finally:
        obs.disable()
        obs.FLIGHT.clear()


def _cold_ms(read, stores, reps: int) -> list:
    """``reps`` wall times of ``read()`` in ms, the stores' tile caches
    emptied before each (their parsed container heads stay)."""
    out = []
    for _ in range(reps):
        for st in stores:
            st.cache.clear()
        t0 = time.perf_counter()
        read()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def cluster_local(root: Path, x, blob, y, frames, chain: dict, eng, kernels,
                  launches: dict) -> dict:
    """Phase 2i, in process: a ``LocalCluster`` of 4 shards on the card.
    ``put`` of phase 2's isabel container (every shard's sparse container
    holds byte-verbatim sections of exactly its tiles, each tile on 2
    shards), ``write`` of the field (the same shard payloads), the 60-tile
    box (= the full decode's crop and a single store's read), the full
    read (= phase 2's decode), phase 2h's 3+1-frame chain (home replicas'
    payloads = phase 2h's store's, ``read_frame(3)`` = its read), then the
    box's first tile's primary owner killed: the same box, 2 gather rounds
    and replica-served tiles.  Launches counted per path around the
    cluster's own calls; timings from separate passes after the checks."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.cluster import LocalCluster
    from repro_torch.core import bitstream
    from repro_torch.store import LopcStore

    box = ROI_REGIONS["straddle"]
    whole = bitstream.read_container_v2(blob)
    ids = eng.tiles_for_region(eng.container_layout(whole), box)
    crop = np.ascontiguousarray(y[box]).tobytes()
    info = {"shards": CLUSTER_SHARDS, "replicas": CLUSTER_REPLICAS,
            "box_tiles": len(ids)}
    single = LopcStore.create(root / "single")
    cl = LocalCluster(root / "cluster", CLUSTER_SHARDS,
                      n_replicas=CLUSTER_REPLICAS)
    try:
        router = cl.router
        check(router.device.type == "cuda", "the cluster's router is off the card")
        t0 = time.perf_counter()
        router.put("isabel", blob)
        info["scatter_ms"] = (time.perf_counter() - t0) * 1e3
        put = _cluster_payloads(cl, "isabel")
        held = [0] * whole.n_tiles
        for shard, payload in put.items():
            c = bitstream.read_container_v2(payload)
            owned = router.map.shard_tiles("isabel", whole.n_tiles, shard)
            present = [t for t, e in enumerate(c.entries) if e.bins_len]
            check(present == owned, f"shard {shard} holds other tiles than "
                  "placement gives it")
            check(all(c.tile_payloads(t) == whole.tile_payloads(t)
                      for t in owned),
                  f"shard {shard}'s sections differ from the container's")
            for t in present:
                held[t] += 1
        check(set(held) == {CLUSTER_REPLICAS},
              f"tiles held by {sorted(set(held))} shards, not {CLUSTER_REPLICAS}")
        info["tiles_per_shard"] = {s: sum(1 for t in range(whole.n_tiles) if s in
                                          router.map.owners("isabel", t))
                                   for s in put}

        kernels.reset_launches()
        t0 = time.perf_counter()
        router.write("isabel", x, EB)
        info["write_s"] = time.perf_counter() - t0
        launches["cluster write"] = dict(kernels.LAUNCHES)
        check(_cluster_payloads(cl, "isabel") == put,
              "router.write's shard payloads differ from the scattered container's")

        single.put("isabel", blob)
        kernels.reset_launches()
        got_box = router.read_roi("isabel", box)
        got_full = router.read("isabel")
        launches["cluster read"] = dict(kernels.LAUNCHES)
        check(got_box.tobytes() == crop, "the cluster's box differs from the "
              "full decode's crop")
        check(single.read_roi("isabel", box).tobytes() == crop,
              "the single store's box differs from the full decode's crop")
        check(got_full.tobytes() == y.tobytes(),
              "the cluster's full read differs from phase 2's decode")
        del got_full
        stores = [w.store for w in cl.workers]
        info["box_cold_ms"] = _cold_ms(lambda: router.read_roi("isabel", box),
                                       stores, CLUSTER_REPS)
        info["single_box_cold_ms"] = _cold_ms(
            lambda: single.read_roi("isabel", box), [single], CLUSTER_REPS)
        info["full_read_ms"] = _cold_ms(lambda: router.read("isabel"), stores, 2)
        info["full_read_MB_s"] = x.nbytes / 1e3 / statistics.median(
            info["full_read_ms"])

        kernels.reset_launches()
        router.write_chain("isabel-chain", frames[:3], chain["eb_abs"], mode="abs")
        t_app = router.append_frame("isabel-chain", frames[3])
        frame3 = router.read_frame("isabel-chain", 3)
        launches["cluster chain"] = dict(kernels.LAUNCHES)
        zigzag = kernels.TRANSFORM_LAUNCHES["encode_ints_fused_zigzag"]
        homes = router.map.home("isabel-chain")
        check(t_app == 3, "the cluster's append gave another frame index")
        check(_cluster_payloads(cl, "isabel-chain")
              == {s: chain["payload"] for s in homes},
              "the chain's home replicas differ from the single store's payload")
        check(frame3.tobytes() == chain["frame3"].tobytes(),
              "the cluster's read_frame(3) differs from the single store's")
        check(zigzag > 0, "the appended residual frame never ran the zigzag")
        info["chain_homes"] = list(homes)
        info["chain_zigzag_launches"] = zigzag

        # where a box read's time goes: its spans, healthy and degraded
        read_box = functools.partial(router.read_roi, "isabel", box)
        got_box, spans = _traced_read(obs, read_box, stores)
        check(got_box.tobytes() == crop, "the traced box read differs")
        info["box_span_ms"] = _span_ms(spans)

        victim = router.map.owners("isabel", ids[0])[0]
        cl.kill(victim)
        failover0 = router.metrics.snapshot()["failover_reads"]
        got_box, spans = _traced_read(obs, read_box, stores)
        info["box_degraded_span_ms"] = _span_ms(spans)
        check(got_box.tobytes() == crop, "the box read after the kill differs")
        gather = [s for s in spans if s.name == "router.gather"]
        check(len(gather) == 1 and gather[0].tags.get("rounds") == 2,
              f"the degraded read's gather rounds: "
              f"{[g.tags.get('rounds') for g in gather]}")
        check(any(s.name == "lprc.call" and s.status == "ShardDown"
                  and s.tags.get("shard") == victim for s in spans),
              "the degraded read has no ShardDown attempt")
        snap = router.metrics.snapshot()
        check(snap["failover_reads"] > failover0,
              "no tile was served by a replica after the kill")
        info["victim"] = victim
        info["failover_tiles"] = gather[0].tags.get("failover_tiles")
        info["box_degraded_cold_ms"] = _cold_ms(
            lambda: router.read_roi("isabel", box), stores, CLUSTER_REPS)
        info["router_metrics"] = snap
    finally:
        cl.close()
        single.close()
    return info


def cluster_socket(out_dir: Path) -> dict:
    """Phase 2i, over sockets: ``python -m repro_torch.launch.serve
    --cluster 4 --trace-out``, four worker subprocesses on the card;
    its reads are byte-identical to a single store (its own check), one
    worker is SIGKILLed mid-serving, and its trace validates in cluster
    mode from at least 2 processes.  The serve process gets a session of
    its own, and the whole session is killed if it outlives its time."""
    import os
    import signal

    from repro_torch import obs

    trace = out_dir / "chip_smoke_cluster_trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--cluster",
           str(CLUSTER_SHARDS), "--trace-out", str(trace)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail("serve --cluster outlived 300 s")
    serve_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"serve --cluster failed ({proc.returncode}): {err[-2000:]}")
    doc = json.loads(trace.read_text())
    schema = json.loads(
        (ROOT / "benchmarks" / "baselines" / "trace_schema.json").read_text())
    errors = obs.validate_trace(doc, schema)
    check(not errors, f"serve --cluster's trace fails the schema: {errors[:3]}")
    pids = {s["pid"] for s in doc["spans"]}
    check(len(pids) >= 2, f"serve --cluster's trace holds {len(pids)} process")
    m = _SERVE_READS.search(out)
    check(m is not None, "serve --cluster printed no read times")
    reads = {sp["trace_id"] for sp in doc["spans"]
             if sp["name"] == "router.read" and sp.get("parent_id") is None}
    return {"serve_s": serve_s, "healthy_s": float(m.group(1)),
            "killed_shard": int(m.group(2)), "degraded_s": float(m.group(3)),
            "spans": len(doc["spans"]), "pids": len(pids),
            "read_traces": len(reads),
            "read_span_ms": _span_ms(sp for sp in doc["spans"]
                                     if sp["trace_id"] in reads),
            "stdout": out.strip().splitlines()}


def cluster_phase(x, blob, y, frames, chain: dict, eng, kernels,
                  launches: dict, single_cold_s: float, card: str) -> dict:
    """Phase 2i: the cluster in process and over sockets."""
    import shutil

    root = ROOT / "build" / "chip_smoke_cluster"
    shutil.rmtree(root, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    try:
        info = cluster_local(root, x, blob, y, frames, chain, eng, kernels,
                             launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info["socket"] = cluster_socket(out_dir)
    for path, need in (("cluster write", ("solve_tiles_blockwise",
                                          "encode_ints_fused")),
                       ("cluster read", ("decode_tiles_fused",)),
                       ("cluster chain", ("solve_tiles_blockwise",
                                          "encode_ints_fused"))):
        for k in need:
            check(launches[path].get(k, 0) > 0, f"{k} never launched on the {path} path")
    med = {k: statistics.median(info[k]) for k in
           ("box_cold_ms", "box_degraded_cold_ms", "single_box_cold_ms")}
    sock = info["socket"]
    log(f"2i cluster: {CLUSTER_SHARDS} shards x{CLUSTER_REPLICAS} in process; "
        f"scatter {info['scatter_ms']:.1f} ms, write {info['write_s']:.2f} s "
        f"(= the scatter's shard payloads); box ({info['box_tiles']} tiles) "
        f"cold {med['box_cold_ms']:.1f} ms healthy, "
        f"{med['box_degraded_cold_ms']:.1f} ms with shard {info['victim']} "
        f"killed ({info['failover_tiles']} tiles from replicas), single store "
        f"{med['single_box_cold_ms']:.1f} ms (phase 2h: "
        f"{single_cold_s * 1e3:.1f}); full read {info['full_read_MB_s']:.1f} "
        f"MB/s; chain replicas = the single store's; serve --cluster "
        f"{CLUSTER_SHARDS}: reads healthy {sock['healthy_s']:.2f} s, degraded "
        f"{sock['degraded_s']:.2f} s, {sock['spans']} spans from "
        f"{sock['pids']} processes, valid, {sock['serve_s']:.1f} s; card {card}")
    for label, ms in (("box, healthy", info["box_span_ms"]),
                      ("box, degraded", info["box_degraded_span_ms"]),
                      (f"serve --cluster's {sock['read_traces']} reads",
                       sock["read_span_ms"])):
        log(f"2i spans ({label}, traced): "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()))
    for line in sock["stdout"]:
        log(f"  serve --cluster | {line}")
    return info


# ---- 2j: distributed compression, the checkpoint, the baselines

SHARD_RANK = """
import hashlib, json, sys, time
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
rank, world, store, field, out, eb = sys.argv[1:7]
rank, world, eb = int(rank), int(world), float(eb)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
try:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels
    from repro_torch.distributed import _collectives, compress_fields_sharded

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    x = np.load(field)
    res = {"rank": rank, "s": []}
    for rep in range(2):  # cold, then warm
        kernels.reset_launches()
        _collectives.reset_counts()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = compress_fields_sharded([x], eb, mesh, device="cuda")[0]
        res["s"].append(time.perf_counter() - t0)
    res["launches"] = dict(kernels.LAUNCHES)
    res["collectives"] = dict(_collectives.COUNTS)
    res["sha256"] = hashlib.sha256(blob).hexdigest()
    Path(out).write_text(json.dumps(res))
finally:
    dist.destroy_process_group()
"""


def sharded_nccl(x, blob, y, eng, kernels, launches: dict, root: Path) -> dict:
    """ISABEL through ``compress_fields_sharded`` over an NCCL group of
    world size 1 in this process: phase 2's container and decode."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import _collectives, compress_fields_sharded

    dist.init_process_group("nccl", store=dist.FileStore(
        str(root / "nccl_store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        times = []
        for rep in range(3):  # cold, then two warm
            kernels.reset_launches()
            _collectives.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = compress_fields_sharded([x], EB, mesh)[0]
            times.append(time.perf_counter() - t0)
            if rep == 0:
                launches["isabel sharded nccl compress"] = dict(kernels.LAUNCHES)
                coll = dict(_collectives.COUNTS)
            check(got == blob, "the NCCL-sharded container differs from "
                               "phase 2's")
    finally:
        dist.destroy_process_group()
    kernels.reset_launches()
    y2 = eng.decompress(got)
    launches["isabel sharded nccl decompress"] = dict(kernels.LAUNCHES)
    check(y2.tobytes() == y.tobytes(),
          "the NCCL-sharded container decodes to other values")
    return {"s": times, "collectives": coll,
            "warm_MB_s": x.nbytes / 1e6 / statistics.median(times[1:])}


def sharded_gloo(x, blob, launches: dict, root: Path, world: int = 2) -> dict:
    """ISABEL through ``compress_fields_sharded`` on ``world`` gloo ranks,
    each a subprocess whose kernels run on the one card."""
    import numpy as np

    field = root / "isabel.npy"
    np.save(field, x)
    want = hashlib.sha256(blob).hexdigest()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    outs = [root / f"gloo_rank{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_RANK, str(r), str(world),
         str(root / "gloo_store"), str(field), str(outs[r]), str(EB)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    t0 = time.perf_counter()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    ranks = []
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"gloo rank {r} failed: {err[-2000:]}")
        res = json.loads(outs[r].read_text())
        check(res["sha256"] == want,
              f"gloo rank {r}'s sharded container differs from phase 2's")
        launches[f"isabel sharded gloo rank{r} compress"] = res["launches"]
        ranks.append(res)
    return {"world": world, "ranks": ranks, "processes_wall_s": wall,
            "warm_s": max(res["s"][1] for res in ranks)}


def checkpoint_path(x, miranda, kernels, launches: dict, root: Path) -> dict:
    """A ``CheckpointManager`` save (async) and restore of ISABEL, a
    Miranda slab, a 4-D leaf and int32 and bf16 leaves; a lossless save;
    a small tree's files against the CPU path's."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree

    eb = 1e-3
    rng = np.random.default_rng(0)
    host = {"isabel": x, "miranda_slab": np.ascontiguousarray(miranda[:64]),
            "x4": rng.standard_normal((16, 32, 64, 64)).astype(np.float32),
            "step": np.asarray(7, np.int32),
            "ids": rng.integers(0, 1 << 20, (4096,)).astype(np.int32)}
    tree = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    bf = torch.from_numpy(rng.standard_normal((512, 512)).astype(np.float32))
    tree["bf"] = bf.to(torch.bfloat16).cuda()
    raw_mb = sum(t.numel() * t.element_size() for t in tree.values()) / 1e6
    mgr = CheckpointManager(root / "ckpt", keep=2, eb=eb, async_save=True)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, tree)
    returned_s = time.perf_counter() - t0
    mgr.wait()
    save_s = time.perf_counter() - t0
    launches["checkpoint save"] = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, step = mgr.restore_latest(tree)
    restore_s = time.perf_counter() - t0
    launches["checkpoint restore"] = dict(kernels.LAUNCHES)
    check(step == 1, "the checkpoint did not restore its step")
    for k in ("isabel", "miranda_slab", "x4"):
        err = float(np.abs(out[k].numpy().astype(np.float64)
                           - host[k].astype(np.float64)).max())
        check(0 < err <= eb, f"checkpoint leaf {k}: error {err} outside (0, {eb}]")
    for k in ("step", "ids"):
        check(np.array_equal(out[k].numpy(), host[k]), f"checkpoint leaf {k} changed")
    check(torch.equal(out["bf"], tree["bf"].cpu()), "checkpoint bf16 leaf changed")
    codecs = {m["path"]: m["codec"] for m in mgr.last_manifest["leaves"]}
    # lossless: the 4-D leaf and an ISABEL cut (kernels 8 and 9, 8's inverse)
    exact = {"x4": tree["x4"], "cut": tree["isabel"][:16]}
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = save_tree(exact, root / "lossless", 0)
    back, _ = restore_tree(exact, root / "lossless")
    lossless_s = time.perf_counter() - t0
    launches["checkpoint lossless"] = dict(kernels.LAUNCHES)
    for k, v in exact.items():
        check(torch.equal(back[k], v.cpu()), f"lossless checkpoint leaf {k} changed")
    # a small tree's files: the card's equal the CPU path's
    small = {"w": host["x4"][:2, :4].copy(), "b": miranda[0, :40, :40].copy(),
             "bf": tree["bf"][:64].cpu()}
    for kw in ({"eb": eb}, {}):
        for dev in ("cuda", "cpu"):
            save_tree(small, root / f"small-{dev}", 0, device=dev, **kw)
        files = [{p.name: p.read_bytes()
                  for p in sorted((root / f"small-{dev}" / "step_0").iterdir())}
                 for dev in ("cuda", "cpu")]
        check(files[0] == files[1],
              f"checkpoint {kw}: the card's leaf files differ from the CPU's")
    return {"raw_MB": raw_mb, "save_s": save_s, "save_returned_s": returned_s,
            "restore_s": restore_s, "save_MB_s": raw_mb / save_s,
            "restore_MB_s": raw_mb / restore_s,
            "stored_MB": mgr.last_manifest["stored_bytes"] / 1e6,
            "codecs": codecs, "lossless_MB": m["raw_bytes"] / 1e6,
            "lossless_save_restore_s": lossless_s}


def baselines_path(x, lopc_ratio: float, plain_ratio: float, kernels,
                   launches: dict) -> dict:
    """The comparison codecs on ISABEL at eb 1e-2 NOA."""
    import numpy as np
    import torch

    from repro_torch.codecs import baselines

    bound = EB * (float(x.max()) - float(x.min()))
    res = {"LOPC": {"ratio": lopc_ratio}, "LOPC plain": {"ratio": plain_ratio}}
    kernels.reset_launches()
    for name, fn in (("pfpl_lite", lambda: baselines.pfpl_lite(x, EB)),
                     ("sz_lorenzo", lambda: baselines.sz_lorenzo(x, EB)),
                     ("topoqz_lite", lambda: baselines.topoqz_lite(x, EB)),
                     ("lossless_fp", lambda: baselines.lossless_fp(x)),
                     ("zstd_raw", lambda: baselines.zstd_raw(x))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        s = time.perf_counter() - t0
        err = float(np.abs(r.decoded.astype(np.float64)
                           - x.astype(np.float64)).max())
        check(err <= (0.0 if name in ("lossless_fp", "zstd_raw") else bound),
              f"baseline {name}: error {err} beyond its bound")
        res[name] = {"ratio": r.ratio, "MB_s": x.nbytes / 1e6 / s,
                     "max_abs_err": err}
        if name == "lossless_fp":
            t0 = time.perf_counter()
            back = baselines.lossless_fp_decode(r.blob)
            res[name]["decode_MB_s"] = x.nbytes / 1e6 / (time.perf_counter() - t0)
            check(back.tobytes() == x.tobytes(), "lossless_fp_decode is not exact")
    launches["baselines isabel"] = dict(kernels.LAUNCHES)
    cut = np.ascontiguousarray(x[:4])
    for name in ("pfpl_lite", "sz_lorenzo", "topoqz_lite"):
        fn = getattr(baselines, name)
        check(fn(cut, EB).blob == fn(cut, EB, device="cpu").blob,
              f"baseline {name}: the card's blob differs from the CPU's on a cut")
    check(baselines.lossless_fp(cut).blob
          == baselines.lossless_fp(cut, device="cpu").blob,
          "baseline lossless_fp: the card's blob differs from the CPU's")
    return res


def distributed_phase(x, blob, y, info: dict, plain_ratio: float, miranda,
                      eng, kernels, launches: dict, card: str) -> dict:
    """Phase 2j: the sharded compress (NCCL world 1, 2 gloo ranks), the
    checkpoint and the baselines."""
    import shutil

    root = ROOT / "build" / "chip_smoke_distributed"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        out = {"nccl": sharded_nccl(x, blob, y, eng, kernels, launches, root),
               "gloo": sharded_gloo(x, blob, launches, root),
               "checkpoint": checkpoint_path(x, miranda, kernels, launches, root),
               "baselines": baselines_path(x, info["ratio"], plain_ratio,
                                           kernels, launches)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for path, need in (("isabel sharded nccl compress",
                        ("solve_tiles_blockwise", "encode_ints_fused")),
                       ("isabel sharded nccl decompress", ("decode_tiles_fused",)),
                       ("isabel sharded gloo rank0 compress",
                        ("solve_tiles_blockwise", "encode_ints_fused")),
                       ("isabel sharded gloo rank1 compress",
                        ("solve_tiles_blockwise", "encode_ints_fused")),
                       ("checkpoint save", ("encode_values_fused",
                                            "encode_ints_fused")),
                       ("checkpoint restore", ("decode_tiles_fused_nosub",)),
                       ("checkpoint lossless", ("bitshuffle_u32",
                                                "rze_bitmap_u32",
                                                "bitunshuffle_u32")),
                       ("baselines isabel", ("bitshuffle_u32", "rze_bitmap_u32",
                                             "bitunshuffle_u32"))):
        for k in need:
            check(launches[path].get(k, 0) > 0, f"{k} never launched on the {path} path")
    nccl, gloo, ck = out["nccl"], out["gloo"], out["checkpoint"]
    log(f"2j sharded: NCCL world 1 = phase 2's container, warm "
        f"{nccl['warm_MB_s']:.1f} MB/s (phase 2: {info['compress_MB_s']:.1f} "
        f"MB/s), collectives {nccl['collectives']}; {gloo['world']} gloo "
        f"ranks = phase 2's container on both, warm {gloo['warm_s']:.3f} s a "
        f"rank (phase 2: {info['raw_MB'] / info['compress_MB_s']:.3f} s), "
        f"processes {gloo['processes_wall_s']:.1f} s, rank 0's collectives "
        f"{gloo['ranks'][0]['collectives']}; card {card}")
    log(f"2j checkpoint: {ck['raw_MB']:.1f} MB saved (async, returned after "
        f"{ck['save_returned_s']:.3f} s) in {ck['save_s']:.2f} s = "
        f"{ck['save_MB_s']:.1f} MB/s to {ck['stored_MB']:.1f} MB, restored in "
        f"{ck['restore_s']:.2f} s = {ck['restore_MB_s']:.1f} MB/s; codecs "
        f"{ck['codecs']}; lossless {ck['lossless_MB']:.1f} MB saved and "
        f"restored in {ck['lossless_save_restore_s']:.2f} s; card {card}")
    log("2j baselines on isabel at eb 1e-2 NOA: " + "; ".join(
        f"{k} ratio {v['ratio']:.3f}"
        + (f" at {v['MB_s']:.1f} MB/s" if "MB_s" in v else "")
        for k, v in out["baselines"].items()) + f"; card {card}")
    log("2j launches: " + json.dumps({k: v for k, v in launches.items()
                                      if "sharded" in k or "checkpoint" in k
                                      or "baselines" in k}))
    return out


# ---- 2k: LM serving
LM_ARCH = "qwen2.5-3b"
LM_SERVE = ("--arch", LM_ARCH, "--requests", "4", "--prompt-len", "48",
            "--gen", "16")
# the card against the CPU, f32 compute: with every cache store in f32,
# the arithmetic alone (the matmuls' summation order) separates the two;
# in the served form the bf16 (int8) K/V stores turn those last-bit
# differences into whole bf16 steps (int8 codes) that later layers carry,
# so it is held to the CPU tests' bf16 (int8) tolerances
LM_RTOL = 1e-4
LM_SERVED_RTOL = {"bf16": 3e-2, "int8": 1e-2}


def lm_serve(card: str) -> dict:
    """2k (a): ``serve --arch`` at the published size, plain and with the
    int8 KV cache, through the CLI's entry point."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    runs = {}
    for kvq in (False, True):
        torch.cuda.empty_cache()
        r = serve.main(list(LM_SERVE) + (["--kv-quant"] if kvq else []))
        cfg = r["config"]
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
               cfg.vocab, cfg.kv_quant) == (36, 2048, 16, 2, 11008, 151936, kvq),
              f"serve ran another config: {cfg}")
        for name in ("prefill_logits", "last_logits"):
            check(tuple(r[name].shape) == (4, 151936)
                  and bool(torch.isfinite(r[name]).all()),
                  f"serve {LM_ARCH} kv_quant={kvq}: {name} not finite (4, V)")
        check(r["tokens"].shape == (17, 4), "serve gave another token count")
        runs["int8-KV" if kvq else "plain"] = {
            "prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
            "tok_s": r["tok_s"], "peak_GB": r["peak_bytes"] / 1e9,
            "tokens": r["tokens"].T.tolist(), "logits": r["prefill_logits"]}
    plain, int8 = (runs[k].pop("logits") for k in ("plain", "int8-KV"))
    runs["prefill_logits_int8_vs_plain"] = float(
        (plain - int8).abs().max()) / max(1.0, float(plain.abs().max()))
    same = sum(a == b for a, b in zip(
        np.ravel(runs["plain"]["tokens"]), np.ravel(runs["int8-KV"]["tokens"])))
    for name in ("plain", "int8-KV"):
        r = runs[name]
        log(f"2k serve {LM_ARCH} [{name}] at full size: prefill 4x48 "
            f"{r['prefill_s']:.3f} s, decode {r['tok_s']:.1f} tok/s "
            f"({r['decode_s']:.3f} s for 64 tokens), peak "
            f"{r['peak_GB']:.2f} GB; card {card}")
    log("2k greedy tokens, plain | int8-KV, per request: " + "; ".join(
        f"{a} | {b}" for a, b in zip(runs["plain"]["tokens"],
                                     runs["int8-KV"]["tokens"]))
        + f" ({same} of 68 equal); prefill logits int8-KV against plain "
        f"{runs['prefill_logits_int8_vs_plain']:.3e} R")
    runs["tokens_equal"] = int(same)
    return runs


def _cache_leaves(tree, prefix=""):
    import numpy as np

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _cache_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def lm_compare(ref_steps, got_steps, label: str, rtol: float,
               tokens: bool) -> dict:
    """Each step's logits and cache leaves of the card's run against the
    CPU's within ``rtol * max(1, max|cpu|)`` (int8 codes: one code), and,
    where ``tokens``, equal greedy tokens."""
    import numpy as np

    worst = {"logits": 0.0, "cache": 0.0, "int8_codes": 0, "tokens_equal": 0}
    for step, ((lc, cc), (lg, cg)) in enumerate(zip(ref_steps, got_steps)):
        err = float(np.abs(lc - lg).max()) / max(1.0, float(np.abs(lc).max()))
        check(err <= rtol, f"2k {label} step {step}: logits differ by "
                           f"{err:.3e} R")
        worst["logits"] = max(worst["logits"], err)
        same = int((lc.argmax(-1) == lg.argmax(-1)).sum())
        check(not tokens or same == len(lc),
              f"2k {label} step {step}: greedy tokens differ")
        worst["tokens_equal"] += same
        got = dict(_cache_leaves(cg))
        for path, a in _cache_leaves(cc):
            b = got[path]
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"2k {label}: {path} shapes or dtypes differ")
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            if a.dtype == np.int8:
                check(d.max() <= 1, f"2k {label} step {step}: {path} int8 "
                                    "codes differ by more than one")
                worst["int8_codes"] = max(worst["int8_codes"], int((d > 0).sum()))
                continue
            err = float(d.max()) / max(1.0, float(np.abs(a).max()))
            check(err <= rtol, f"2k {label} step {step}: {path} differs by "
                               f"{err:.3e} R")
            worst["cache"] = max(worst["cache"], err)
    return worst


def lm_agreement(card: str) -> dict:
    """2k (b): the card against the CPU on the same torch code, f32
    compute, TF32 off; each case twice: every cache store in f32 (the
    arithmetic, ``LM_RTOL``, equal greedy tokens) and as served."""
    import copy

    import torch

    from repro_torch.models import ARCHITECTURES, get_arch, reduced_for_smoke
    from repro_torch.models.convert import cache_to_reference
    from repro_torch.models.inputs import dummy_batch
    from repro_torch.models.model import Model

    def f32_stores(model):
        real = model.init_cache

        def init_cache(batch, max_len):
            def up(t):
                if isinstance(t, dict):
                    return {k: up(v) for k, v in t.items()}
                if isinstance(t, list):
                    return [up(v) for v in t]
                return t.float() if isinstance(t, torch.Tensor) \
                    and t.dtype == torch.bfloat16 else t
            return up(real(batch, max_len))
        model.init_cache = init_cache  # this instance only

    def steps(model, cfg, batch, max_len, tokens=None):
        logits, caches = model.prefill(batch, max_len)
        out = [(logits.cpu().numpy(), cache_to_reference(caches, cfg))]
        for t in range(2):
            tok = (logits.argmax(-1).cpu() if tokens is None
                   else torch.from_numpy(tokens[t]))
            logits, caches = model.decode_step(tok, caches)
            out.append((logits.cpu().numpy(), cache_to_reference(caches, cfg)))
        return out

    full = get_arch(LM_ARCH).config.scaled(n_layers=2, dtype="float32")
    cases = [(f"{LM_ARCH} 2 layers", full, 4, 48),
             (f"{LM_ARCH} 2 layers int8-KV", full.scaled(kv_quant=True), 4, 48)]
    cases += [(f"{a} reduced", reduced_for_smoke(get_arch(a).config).scaled(
        dtype="float32"), 2, 20) for a in ARCHITECTURES
        if a != LM_ARCH and "decode_32k" not in get_arch(a).skip_shapes]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        with torch.inference_mode():
            for label, cfg, b, s in cases:
                t0 = time.perf_counter()
                gpu = Model(cfg, seed=0, device="cuda")
                cpu = copy.deepcopy(gpu).to("cpu")
                batch = dummy_batch(cfg, b, s)
                res = {}
                forms = (("served", LM_SERVED_RTOL["int8" if cfg.kv_quant
                                                   else "bf16"], False),)
                if not cfg.kv_quant:  # int8 stores have no f32 form
                    forms = (("f32 stores", LM_RTOL, True),) + forms
                for form, rtol, tokens in forms:
                    if form == "f32 stores":
                        f32_stores(gpu)
                        f32_stores(cpu)
                    else:
                        gpu.__dict__.pop("init_cache", None)
                        cpu.__dict__.pop("init_cache", None)
                    ref = steps(cpu, cfg, batch, s + 2)
                    got = steps(gpu, cfg, batch, s + 2,
                                [lc.argmax(-1) for lc, _ in ref])
                    res[form] = lm_compare(ref, got, f"{label} ({form})", rtol,
                                           tokens)
                del gpu, cpu
                res["s"] = time.perf_counter() - t0
                out[label] = res
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    log("2k card against the CPU (f32 compute, TF32 off; max |d| / R of the "
        "logits and caches, int8 codes off, greedy tokens equal of "
        "3 steps): " + "; ".join(
            f"{k}: " + ", ".join(
                f"{form} {v[form]['logits']:.2e} / {v[form]['cache']:.2e}"
                f" / {v[form]['int8_codes']} / {v[form]['tokens_equal']}"
                for form in v if form != "s") + f" ({v['s']:.1f} s)"
            for k, v in out.items()) + f"; card {card}")
    return out


def lm_offload(eng, kernels, launches: dict, card: str) -> dict:
    """2k (c): the full qwen's prefill caches through the service on the
    card (the KV example's own functions), launches counted around the
    service's compress and decompress alone."""
    import importlib.util

    import torch

    from repro_torch.engine.plan import CompressionPlan
    from repro_torch.models import get_arch
    from repro_torch.models.model import clone_cache

    spec = importlib.util.spec_from_file_location(
        "serve_kv_compress_torch", ROOT / "examples" / "serve_kv_compress_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = get_arch(LM_ARCH).config
    with torch.inference_mode():
        model, logits, caches = ex.prefill(cfg, "cuda", 4, 48, 16)
        blocks = ex.kv_blocks(caches, cfg)
        check(len(blocks) == 72 and all(x.shape == (4, 2 * 64 * 128)
                                        for x in blocks.values()),
              "2k: the full qwen's KV blocks are not 72 of (4, 16384)")
        offload_s = []
        for rep in range(2):  # cold (new tile layouts), then warm
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payloads, restored, m = ex.offload(blocks, "cuda")
            torch.cuda.synchronize()
            offload_s.append(time.perf_counter() - t0)
            if rep == 0:
                launches["kv C/D"] = dict(kernels.LAUNCHES)
        for k in ("solve_tiles_blockwise", "encode_ints_fused", "decode_tiles_fused"):
            check(launches["kv C/D"].get(k, 0) > 0, f"{k} never launched on the "
                                                    "KV offload path")
        kerr = ex.check_offload(blocks, payloads, restored, "cuda")
        plan = CompressionPlan(tile_shape=ex.TILE)
        keys = list(blocks)[:2] + list(blocks)[-2:]
        for key in keys:
            check(payloads[key] == eng.compress(blocks[key], ex.EB, mode="abs",
                                                plan=plan, device="cpu"),
                  f"2k: KV block {key}'s container differs from the CPU's")
        spare = clone_cache(caches)  # the prefill's state, for the profile
        drift = ex.decode_drift(model, logits, caches,
                                ex.restored_k(caches, restored, cfg), 16)
        tok = logits.argmax(-1)
        step = profile_calls({"decode step": lambda: model.decode_step(
            tok, spare)}, host=("decode step",))["decode step"]
        del model, caches, spare
    torch.cuda.empty_cache()
    raw = sum(x.nbytes for x in blocks.values())
    comp = sum(len(b) for b in payloads.values())
    out = {"blocks": len(blocks), "raw_MB": raw / 1e6, "stored_MB": comp / 1e6,
           "ratio": raw / comp, "max_err": kerr, "offload_s": offload_s,
           "MB_s": [2 * raw / 1e6 / t for t in offload_s],
           "cpu_equal_blocks": len(keys),
           "occupancy_mean": m.mean_batch_occupancy,
           "device_groups": m.device_groups, "drift": drift["drift"],
           "drift_tokens_equal": drift["same"], "decode_s": drift["s"],
           "decode_step_profile": step}
    log(f"2k KV offload: {len(blocks)} blocks, {raw / 1e6:.2f} MB -> "
        f"{comp / 1e6:.2f} MB ({out['ratio']:.3f}x), max err {kerr:.3e} <= "
        f"{ex.EB}; compress+decompress through the service cold "
        f"{offload_s[0]:.3f} s, warm {offload_s[1]:.3f} s ({out['MB_s'][0]:.1f}"
        f", {out['MB_s'][1]:.1f} MB/s of raw bytes each way), batch occupancy "
        f"{m.mean_batch_occupancy:.1f}, {m.device_groups} device groups; "
        f"{len(keys)} containers equal the CPU's; launches "
        f"{launches['kv C/D']}; logit drift over 16 decode steps on restored K "
        f"{drift['drift']:.4f}, argmax identical: {drift['same']}; card {card}")
    busy = ("not measured (empty device trace)"
            if step["device_busy_ms"] is None else
            f"{step['device_busy_ms']:.2f} ms (idle share "
            f"{step['device_idle_share']:.3f})")
    log(f"2k profile of one warm decode step of the full qwen (4 requests): "
        f"wall {step['wall_ms']:.2f} ms, device busy {busy}; top: "
        + "; ".join(f"{t['kernel'][:40]} {t['ms']:.3f} ms x{t['calls']}"
                    for t in step["top"][:6])
        + "; host (cProfile cumulative share): " + "; ".join(
            f"{h['function']} {h['share']:.2f}"
            for h in step["host_cumulative_share"][:8]) + f"; card {card}")
    return out


def lm_phase(eng, kernels, launches: dict, card: str) -> dict:
    """Phase 2k: serving at full size, the card against the CPU, and the
    KV offload."""
    return {"serve": lm_serve(card), "agreement": lm_agreement(card),
            "offload": lm_offload(eng, kernels, launches, card)}


# (tile-straddling box, box inside one (16, 16, 64) tile, one-cell slab)
ROI_REGIONS = {
    "straddle": (slice(10, 40), slice(100, 170), slice(50, 200)),
    "one tile": (slice(17, 30), slice(20, 30), slice(70, 120)),
    "slab": (slice(50, 51), slice(None), slice(None)),
}


def roi_phase(containers, eng, executor) -> dict:
    """Phase 2c: region reads of full-size containers against the full
    decode's crop, with the decoded tiles counted; one
    ``decode_tiles_many`` across two containers; the straddling box
    timed against the full decompress."""
    import numpy as np

    from repro_torch.core import bitstream

    out = {}
    for label, blob in containers.items():
        full = eng.decompress(blob)
        c = bitstream.read_container_v2(blob)
        layout = eng.container_layout(c)
        rows = {}
        for rname, region in ROI_REGIONS.items():
            executor.reset_decode_counts()
            got = eng.decompress_roi(blob, region)
            ids = eng.tiles_for_region(layout, region)
            check(got.tobytes() == np.ascontiguousarray(full[region]).tobytes(),
                  f"ROI {rname} of {label}: differs from the full decode's crop")
            check(executor.DECODE_COUNTS["tiles"] == len(ids),
                  f"ROI {rname} of {label}: decoded "
                  f"{executor.DECODE_COUNTS['tiles']} tiles, region needs {len(ids)}")
            rows[rname] = {"tiles": len(ids), "of": layout.n_tiles,
                           "shape": list(got.shape)}
        t_roi, t_full = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.decompress_roi(blob, ROI_REGIONS["straddle"])
            t_roi.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            eng.decompress(blob)
            t_full.append(time.perf_counter() - t0)
        rows["straddle_s"] = statistics.median(t_roi)
        rows["full_decompress_s"] = statistics.median(t_full)
        out[label] = rows
        log(f"ROI {label}: 3 regions equal the full decode's crop, tiles "
            + ", ".join(f"{k} {v['tiles']}/{v['of']}" for k, v in rows.items()
                        if isinstance(v, dict))
            + f"; straddling box {rows['straddle_s'] * 1e3:.1f} ms vs full "
            f"decompress {rows['full_decompress_s'] * 1e3:.1f} ms (medians of 3)")
    labels = list(containers)[:2]
    runs = [(containers[lb], list(range(i, 40, 3))) for i, lb in enumerate(labels)]
    executor.reset_decode_counts()
    many = eng.decode_tiles_many(runs)
    check(executor.DECODE_COUNTS["tiles"] == sum(len(t) for _, t in runs),
          "decode_tiles_many decoded another number of tiles")
    for (blob, ids), got in zip(runs, many):
        one = eng.decode_tiles_for_region(blob, ids)
        check(got.tobytes() == one.tobytes(),
              "decode_tiles_many differs from the single-container read")
    log(f"decode_tiles_many over {labels}: equals the single-container reads")
    return out


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


def full_size_agreement(x, blob, y, eng, info: dict, cpu_compress: bool,
                        y_v1) -> None:
    """Hold one full-size card run against computations that share none
    of its tiling, halo rounds, batching or device: the whole-field
    reconstruction on the card (which the v1 decode ``y_v1`` must equal
    too), the container decoded on the CPU and, if ``cpu_compress``, the
    field compressed on the CPU."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    y_ref, sweeps = whole_field_reference(x, EB)
    check(bits_equal(torch.from_numpy(y).cuda(), y_ref),
          f"{info['field']}: decoded values differ from the whole-field "
          "reconstruction")
    check(bits_equal(torch.from_numpy(y_v1).cuda(), y_ref),
          f"{info['field']}: the v1 decode differs from the whole-field "
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
    log(f"full size {info['field']}: decoded values (tiled and v1) equal "
        f"the whole-field reconstruction ({sweeps} global sweeps) and the "
        "CPU decode"
        + ("; container equals the CPU's" if cpu_compress else ""))


def warm_timing(x, blob, y, eng, info: dict, **kw) -> None:
    """Warm compress and decompress, median of 3; every run must give the
    same bytes and values again."""
    import torch

    tc, td = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2 = eng.compress(x, info.get("eb", EB), **kw)
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


def profile(name, shape, dtype, eng, make_field, **kw) -> dict:
    """Where one warm compress and one warm decompress spend their time:
    device time by kernel and memcpy (torch.profiler, CUPTI), the
    device's idle share of the wall time, and the host functions of the
    port by cumulative time (cProfile, a separate run: it slows Python
    code, so read its shares, not its seconds; ISABEL's fields only, as
    the run's time limit leaves no room for Miranda's, whose cells other
    than the uniform one take no profile at all)."""
    import numpy as np

    x = make_field(name, shape, np.dtype(dtype), seed=0)
    blob = eng.compress(x, EB, **kw)
    return profile_calls({"compress": lambda: eng.compress(x, EB, **kw),
                          "decompress": lambda: eng.decompress(blob)},
                         host=("compress", "decompress")
                         if name == ISABEL[0] else ())


def profile_calls(calls: dict, host=("compress", "decompress")) -> dict:
    """``profile``'s measurements of each warm call in ``calls`` (name ->
    function): the device trace of each, the host's shares of those named
    in ``host``."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out = {}
    for what, fn in calls.items():
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
        funcs, total = [], 1.0
        if what in host:
            prof_host = cProfile.Profile()
            prof_host.enable()
            fn()
            prof_host.disable()
            stats = pstats.Stats(prof_host).stats
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

def tiny_bound_runs(eng, kernels, ops) -> None:
    """Bounds within 2x of the smallest normal: a field of 4 * tiny *
    N(0, 1) cells (about a fifth subnormal) at eb = 1.5 * tiny, f32 and
    f64, order-preserving and plain (the fused value encode for f32):
    the container and the decode must equal the CPU path's, which holds
    the quantize and decode kernels (3, 3' and 4) to the reference's
    subnormal flushes; the same at eb = 4 * tiny, where kernel 4 flushes
    only the cells; and the FF32 pair (6, 7) at eps 1.5 * tiny against
    its plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    rng = np.random.default_rng(0)
    for dt in (np.float32, np.float64):
        tiny = float(np.finfo(dt).tiny)
        x = (4 * tiny * rng.standard_normal((32, 64, 128))).astype(dt)
        for eb, kw, need in (
                (1.5 * tiny, {}, ("solve_tiles_blockwise", "decode_tiles_fused")),
                (1.5 * tiny, {"preserve_order": False, "encode_path": "fused"},
                 ("encode_values_fused" if dt == np.float32
                  else "encode_ints_fused", "decode_tiles_fused_nosub")),
                (4 * tiny, {"preserve_order": False, "encode_path": "fused"},
                 ("encode_values_fused" if dt == np.float32
                  else "encode_ints_fused", "decode_tiles_fused_nosub"))):
            kernels.reset_launches()
            blob = eng.compress(x, eb, mode="abs", **kw)
            y = eng.decompress(blob)
            got = dict(kernels.LAUNCHES)
            for k in need:
                check(got.get(k, 0) > 0, f"tiny bound {np.dtype(dt).name} "
                      f"eb {eb:.6g} {kw}: {k} never launched")
            check(blob == eng.compress(x, eb, mode="abs", device="cpu", **kw),
                  f"tiny bound {np.dtype(dt).name} eb {eb:.6g} {kw}: the "
                  "container differs from the CPU's")
            check(y.tobytes() == eng.decompress(blob, device="cpu").tobytes(),
                  f"tiny bound {np.dtype(dt).name} eb {eb:.6g} {kw}: the "
                  "decode differs from the CPU's")
        log(f"tiny bound {np.dtype(dt).name}: containers and decodes equal "
            "the CPU's (eb 1.5 tiny order-preserving and plain, eb 4 tiny "
            "plain)")
    x32 = torch.from_numpy(
        (4 * np.finfo(np.float32).tiny * rng.standard_normal(1 << 20))
        .astype(np.float32)).cuda()
    eps = np.float32(1.5 * np.finfo(np.float32).tiny)
    bins = ops.quantize_ff32(x32, eps)
    check(torch.equal(bins, ref.quantize_ff32_ref(x32, eps)),
          "the FF32 quantize differs from its plain version at eps 1.5 tiny")
    sub = torch.from_numpy(rng.integers(0, 3, 1 << 20).astype(np.int32)).cuda()
    check(bits_equal(ops.dequantize_ff32(bins, sub, eps),
                     ref.dequantize_ff32_ref(bins, sub, eps)),
          "the FF32 dequantize differs from its plain version at eps 1.5 tiny")
    log("tiny bound FF32: the quantize and dequantize kernels equal their "
        "plain versions at eps 1.5 tiny")


def bound_ms(name, args, out) -> tuple[float, str]:
    """Least time for this call's work: max(bytes / HBM rate, integer ops
    / peak rate), counting each input read once and each output written
    once, and the work this run's data needs."""
    import torch

    if name == "solve_blockwise":
        flags = args[0]
        sub, sweeps = out
        nbytes = flags.nbytes + sub.nbytes
        pop = sum(int(((flags >> k) & 1).sum()) for k in range(14))
        # a set flag bit is an add and a max at least once per global
        # sweep (the sweep that finds the bands at their fixed point too)
        ops = float(2 * pop * sweeps)
    elif name in ("bitshuffle_u32", "bitunshuffle_u32"):
        nbytes = args[0].nbytes + out.nbytes
        ops = float(args[0].numel() * 32)  # one per bit
    elif name == "rze_bitmap_u32":
        bitmap, counts = out
        nbytes = args[0].nbytes + bitmap.nbytes + counts.nbytes
        ops = float(args[0].numel())  # one test per word
    elif name in ("quantize_ff32", "dequantize_ff32"):
        nbytes = sum(a.nbytes for a in args if hasattr(a, "nbytes")) + out.nbytes
        # quantize: a multiply, a rounding, then twice a conversion, two
        # adds, two multiplies and two compares; dequantize: a conversion,
        # an add and a multiply (its ordered-int add is integer work)
        per = 16 if name == "quantize_ff32" else 3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = out.numel() * per / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    elif name.startswith("solve_tiles_blockwise"):
        sub_h, flags = args
        res, iters = out
        nbytes = sub_h.nbytes + flags.nbytes + res.nbytes + iters.nbytes
        pop = sum(((flags >> k) & 1).reshape(flags.shape[0], -1).sum(1)
                  for k in range(14))
        # a set flag bit is an add and a max once: the sweep that proves
        # the fixed point (the sweeps before it need not visit every bit,
        # as the frontier Jacobi shows)
        ops = float(2 * pop.sum())
    elif name == "encode_ints_fused":
        ints = args[0]
        bitmap, words, counts = out
        nbytes = ints.nbytes + bitmap.nbytes + words.nbytes + counts.nbytes
        ops = float(words.numel() * words.element_size() * 8)  # one per bit
    elif name == "encode_values_fused":
        x_int, eps = args[:2]
        bitmap, words, counts = out
        nbytes = (x_int.nbytes + eps.nbytes + bitmap.nbytes + words.nbytes
                  + counts.nbytes)
        # f64 per cell: one divide, then four decode_base evaluations (a
        # subtract and a multiply each); the integer chain as above
        t_f64 = x_int.numel() * 9 / F64_OPS_PER_S * 1e3
        t_int = words.numel() * words.element_size() * 8 / INT_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_f64 + t_int
                else (t_f64 + t_int, "operations"))
    elif name == "decode_tiles_fused_nosub":
        bitmap, packed, _, _, eps = args[:5]
        nbytes = (bitmap.nbytes + int((packed != 0).sum()) * packed.element_size()
                  + eps.nbytes + out.nbytes)
        ops = float(out.numel() * 8 * packed.element_size())
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


def band_cases(rec, topology, quantize) -> list:
    """Operands of the band solve's kernel-vs-plain checks: ISABEL's whole
    flags (first, the timed one), the first 32 X-rows of each field's
    flags, a 128x4x4 field descending in X inside one bin (one chain
    across the whole X extent, as in the reference's test), a serpentine,
    a front, and a chain through all of one tile (under the kernel's pass
    cap and under a cap of 8 passes).  Each case is (label, operands, pass
    cap or None for the default)."""
    import torch

    whole = [rec.calls[k][0] for k in rec.calls if k[0] == "solve_blockwise"]
    check(len(whole) >= 2, "solve_blockwise: a full-size field was not recorded")
    cases = [(f"whole {tuple(whole[0][0].shape)}", whole[0], None)]
    # the flags of the sub-field x[:32]: its last row has no neighbour at
    # x + 1 (a bit set there would read the clamped halo of the last band,
    # which can close a cycle and never converge)
    up = sum(1 << k for k, off in enumerate(topology.offsets(3)) if off[0] > 0)
    for (flags,) in whole[:2]:
        cut = flags[:32].clone()
        cut[-1] &= ~up
        cases.append((f"first 32 X-rows of {tuple(flags.shape)}", (cut,), None))
    x = -torch.cumsum(torch.full((128, 4, 4), 1e-9, dtype=torch.float64,
                                 device=whole[0][0].device), dim=0)
    bins = quantize.quantize(x, 1.0)
    cases.append(("128x4x4 chain", (topology.order_flags(bins, x),), None))
    x = serpentine(8, 40, 150).to(whole[0][0].device)
    bins = quantize.quantize(x, 1.0)
    cases.append(("8x40x150 serpentine", (topology.order_flags(bins, x),),
                  None))
    # rising in X inside one bin, X-row 0 falling in Z: row 0's subbins
    # reach one band more each global sweep, each band still until then
    x = torch.arange(64, dtype=torch.float64)[:, None, None] * 1e-9 + torch.zeros(
        (64, 40, 150), dtype=torch.float64)
    x[0] = -torch.arange(150, dtype=torch.float64) * 1e-12
    x = x.to(whole[0][0].device)
    bins = quantize.quantize(x, 1.0)
    cases.append(("64x40x150 front", (topology.order_flags(bins, x),), None))
    # 8191 hops inside the one 8x16x64 tile of the middle band: a warp's
    # lanes read before they write, so it needs some 8000 passes, beyond
    # the kernel's cap of 4096; under a cap of 8, hundreds of launches
    x = in_tile_chain().to(whole[0][0].device)
    flags = topology.order_flags(quantize.quantize(x, 1.0), x)
    cases.append(("24x16x64 in-tile chain", (flags,), None))
    cases.append(("24x16x64 in-tile chain, cap 8 passes", (flags,), 8))
    return cases


def in_tile_chain():
    """(24, 16, 64) f64 field whose middle band falls along a 3-D
    boustrophedon through all 8192 cells of the band kernel's one tile
    there, inside one bin at eb 1 (Z forward and backward by turns, Y
    likewise in each X-row); the other bands are a wall in another bin,
    so the tile's X halo never moves and it has no neighbour tile."""
    import torch

    v = torch.full((24, 16, 64), 3.0, dtype=torch.float64)
    step = 0
    for a in range(8):
        ys = range(16) if a % 2 == 0 else range(15, -1, -1)
        for n, b in enumerate(ys):
            zs = torch.arange(64) if (a * 16 + n) % 2 == 0 else torch.arange(63, -1, -1)
            v[8 + a, b, zs] = -torch.arange(step, step + 64, dtype=torch.float64) * 1e-9
            step += 64
    return v


def serpentine(x: int, y: int, z: int):
    """(x, y, z) f64 field constant in X whose values fall along a corridor
    winding through the whole Y x Z plane (Z forward on rows 0, 4, ...,
    backward on rows 2, 6, ..., joined at the turns by one cell of the odd
    row between), inside one bin at eb 1; the rest of the odd rows is a
    wall in another bin.  Its one chain crosses the band kernel's 16 x 64
    tiles again and again; Y and Z are not multiples of the tile."""
    import torch

    v = torch.full((y, z), 3.0, dtype=torch.float64)
    step = 0
    for r in range(0, y, 2):
        cols = list(range(z)) if r % 4 == 0 else list(range(z - 1, -1, -1))
        v[r, cols] = -torch.arange(step, step + z, dtype=torch.float64) * 1e-9
        step += z
        if r + 1 < y:
            v[r + 1, cols[-1]] = -step * 1e-9
            step += 1
    return v.expand(x, y, z).contiguous()


def _same(a, b) -> tuple[bool, float]:
    if hasattr(a, "shape"):
        # bit-equal values are 0 apart even where they are inf or NaN
        same = bits_equal(a, b)
        return same, 0.0 if same else max_abs_err(a, b)
    return a == b, float(abs(a - b))  # a sweep count


def band_whole_timing(kern, args, card: str) -> dict:
    """Miranda's whole band solve (the v1 compress's) by CUDA events: one
    call, its launches and global sweeps, and its bound."""
    import torch

    from repro_torch import kernels

    kern(*args)  # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = kern(*args)
    end.record()
    torch.cuda.synchronize()
    n = kernels.LAUNCHES["solve_blockwise"]
    b_ms, b_by = bound_ms("solve_blockwise", args, out)
    info = {"shape": list(args[0].shape), "ms": start.elapsed_time(end),
            "launches": n, "sweeps": out[1], "launches_per_sweep": n / out[1],
            "bound_ms": b_ms, "bound_by": b_by, "card": card}
    log(f"band solve, whole {tuple(args[0].shape)}: {info['ms']:.3f} ms by "
        f"CUDA events, {n} launches over {out[1]} global sweeps "
        f"({info['launches_per_sweep']:.2f} per sweep), bound {b_ms:.4f} ms "
        f"by {b_by}; card {card}")
    return info


def solve_rounds_timing(rec, lane: str, card: str) -> dict:
    """Every round of the first main-path resident solve of ``lane``,
    replayed: the kernel's time per round by CUDA events with the round's
    tiles, then the same rounds again for their bounds."""
    import torch

    from repro_torch.engine import device as device_mod

    flags, idx, mask, max_rounds, adj, sub0, n_real = rec.solves[(lane, "")]
    real = rec.real["solve_tiles_blockwise"]
    wrapped = device_mod.solve_tiles_blockwise
    timed, bounds = [], []

    def by_events(sub_h, fl):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(sub_h, fl)
        end.record()
        timed.append((sub_h.shape[0], start, end))
        return out

    def by_bound(sub_h, fl):
        out = real(sub_h, fl)
        bounds.append(bound_ms(lane, (sub_h, fl), out)[0])
        return out

    solve = rec.real["resident_solve"]
    try:
        device_mod.solve_tiles_blockwise = by_events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solve(flags, idx, mask, max_rounds, adjacency=adj, sub0=sub0,
              n_real=n_real)
        end.record()
        torch.cuda.synchronize()
        device_mod.solve_tiles_blockwise = by_bound
        solve(flags, idx, mask, max_rounds, adjacency=adj, sub0=sub0,
              n_real=n_real)
    finally:
        device_mod.solve_tiles_blockwise = wrapped
    rounds = [{"tiles": n, "ms": a.elapsed_time(b), "bound_ms": bd}
              for (n, a, b), bd in zip(timed, bounds)]
    info = {"solve_ms": start.elapsed_time(end), "launches": len(rounds),
            "kernel_ms": sum(r["ms"] for r in rounds),
            "bound_ms": sum(r["bound_ms"] for r in rounds),
            "per_round": rounds, "card": card}
    log(f"{lane}: one resident solve {info['solve_ms']:.3f} ms by CUDA "
        f"events, {len(rounds)} launches, kernel {info['kernel_ms']:.3f} ms "
        f"against a bound of {info['bound_ms']:.4f} ms; (tiles, ms) per "
        "round: " + ", ".join(f"({r['tiles']}, {r['ms']:.3f})"
                               for r in rounds) + f"; card {card}")
    return info


# the fused encode and decode (kernels 2, 3, 3') and kernel 4, which
# shares the encode: each also runs the adversarial cases of
# `fused_cases` and is timed on every signature the paths recorded
FUSED = ("encode_ints_fused", "decode_tiles_fused", "decode_tiles_fused_nosub",
         "encode_values_fused")
SIGNED = {16: "int16", 32: "int32", 64: "int64"}


def _ints_case(rng, batch: int, elems: int, w: int, kind: str):
    """(batch, elems) w-bit ints: a random walk (with a zero tile for
    "zero chunk"), every word random ("dense": every plane word nonzero,
    about), or words at the zigzag and wrap extremes, -2^(w-1),
    2^(w-1) - 1, -1, 0, 1 in turn."""
    import numpy as np

    dt = np.dtype(SIGNED[w])
    info = np.iinfo(dt)
    if kind == "extremes":
        cycle = np.array([info.min, info.max, -1, 0, 1, info.min, 0, info.max],
                         dtype=dt)
        return np.resize(cycle, (batch, elems)).astype(dt)
    if kind == "dense":
        return rng.integers(info.min, info.max, (batch, elems), dtype=dt,
                            endpoint=True)
    x = (np.cumsum(rng.integers(-3, 4, (batch, elems)), axis=1)
         + rng.integers(-2**12, 2**12, (batch, 1))).astype(dt)
    if kind == "zero chunk":
        x[0] = 0
    return x


def _stream_case(ints, transform: str, full: bool, rng):
    """(bitmap, front-packed words) rows of an int batch on the card, by
    the plain encode; ``full``: the first tile's rows get every bitmap bit
    set and random nonzero words."""
    import numpy as np
    import torch

    from repro_torch.kernels import fused_encode

    w = ints.dtype.itemsize * 8
    bm, words, _ = fused_encode.encode_ints_plain(
        torch.from_numpy(ints).cuda(), 131072 // w, transform)
    bm, words = bm.cpu().numpy(), words.cpu().numpy()
    packed = np.zeros_like(words)
    for r in range(words.shape[0]):
        nz = words[r][words[r] != 0]
        packed[r, : nz.size] = nz
    if full:
        cpt = bm.shape[0] // ints.shape[0]
        bm[:cpt] = -1
        packed[:cpt] = (rng.integers(1, 2**15, packed[:cpt].shape)
                        * rng.choice([-1, 1], packed[:cpt].shape)).astype(words.dtype)
    return torch.from_numpy(bm).cuda(), torch.from_numpy(packed).cuda()


def fused_cases(name: str) -> list:
    """Adversarial operands of the fused encode and decode kernels (2, 3,
    3') and of kernel 4: every pair of bins and subbin widths (16/32/64)
    at f32 and f64, the 3-D plan tile (16384 cells), the 1-D and 2-D ones
    (4096, not a whole number of 16-bit chunks), an odd count, batch 1,
    an all-zero tile, a tile whose bitmap rows have every bit set, and
    words at the zigzag and wrap extremes.  Each case is (label,
    operands)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(16)
    kinds = ("random", "zero chunk", "full bitmap", "extremes")
    shapes = [(4, 16384, k) for k in kinds] + [(3, 4096, k) for k in kinds] + [
        (1, 16384, "random"), (2, 8192 + 100, "random")]
    cases = []
    if name == "encode_ints_fused":
        for w in (16, 32, 64):
            for transform in ("delta", "raw", "zigzag"):
                for batch, elems, kind in shapes:
                    kind = "dense" if kind == "full bitmap" else kind
                    ints = torch.from_numpy(
                        _ints_case(rng, batch, elems, w, kind)).cuda()
                    cases.append((f"adversarial {kind} ({batch}, {elems}) "
                                  f"int{w} {transform}",
                                  (ints, 131072 // w, transform)))
    elif name == "encode_values_fused":
        for w in (16, 32):
            for batch, elems, kind in shapes[::4] + shapes[-2:]:
                x = (rng.standard_normal((batch, elems))
                     * (30.0 if w == 16 else 3e4)).astype(np.float32)
                x[:, elems - 37:] = np.nan   # tile pad
                x[0, :3] = [np.inf, -np.inf, -0.0]
                x[0, 6:40] = np.float32(1e-41) * np.arange(34)
                eps = torch.from_numpy(rng.uniform(1e-3, 1.0, batch)).cuda()
                cases.append((f"adversarial ({batch}, {elems}) int{w} bins",
                              (torch.from_numpy(x).cuda(), eps, 131072 // w,
                               torch.float32, getattr(torch, SIGNED[w]))))
            # cells where the fast quantize and its fallback meet
            # (``adversarial_cells``), a tile per eps (1e-6 .. 1 and
            # bounds within 2x of the smallest normal), whole and odd tiles
            models = _partition_models()
            tiny = models.F32_TINY
            epss = list(np.geomspace(1e-6, 1.0, 7)) + [
                2.0**-10, 1.5 * tiny, 2 * tiny, 4 * tiny]
            for elems in (16384, 8192 + 101):
                x = np.stack([np.resize(models.adversarial_cells(rng, e), elems)
                              for e in epss]).astype(np.float32)
                cases.append((f"adversarial cells ({len(epss)}, {elems}) "
                              f"int{w} bins, TINY tiles included",
                              (torch.from_numpy(x).cuda(),
                               torch.tensor(epss, dtype=torch.float64).cuda(),
                               131072 // w, torch.float32,
                               getattr(torch, SIGNED[w]))))
    else:
        pairs = ([(bw, None) for bw in (16, 32, 64)]
                 if name == "decode_tiles_fused_nosub" else
                 [(bw, sw) for bw in (16, 32, 64) for sw in (16, 32, 64)])
        for bw, sw in pairs:
            for dtype in (torch.float32, torch.float64):
                for batch, elems, kind in shapes:
                    full = kind == "full bitmap"
                    ints_kind = "random" if full else kind
                    bins = _ints_case(rng, batch, elems, bw, ints_kind)
                    args = list(_stream_case(bins, "delta", full, rng))
                    if sw is None:
                        args += [None, None]
                    else:
                        subs = (_ints_case(rng, batch, elems, sw, ints_kind)
                                if kind == "extremes" else
                                rng.integers(0, 9, (batch, elems))
                                .astype(SIGNED[sw]))
                        if kind == "zero chunk":
                            subs[0] = 0
                        args += list(_stream_case(subs, "raw", full, rng))
                    eps = np.resize([1e-3, 2.5e-2, 0.7, 3.0] if dtype ==
                                    torch.float32 else [1e-9, 3e-4, 2.0, 0.5],
                                    batch)
                    cases.append((
                        f"adversarial {kind} ({batch}, {elems}) bins int{bw} "
                        f"subbins {'none' if sw is None else f'int{sw}'} "
                        f"{str(dtype)[6:]}",
                        (*args, torch.from_numpy(eps).cuda(), elems, dtype)))
    return cases


def _partition_models():
    """The CPU models' operand generators (tests/test_torch_partition.py:
    numpy and the port only), so the card runs the cases the models
    were held to."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_partition

    return test_torch_partition


def bit4_cases(name: str) -> list:
    """Adversarial operands of the BIT_4 transpose (kernel 8): 1, 2, 3 and
    6104 chunks of random words, then all zero, all ones, one set bit at
    each of the 32 positions, 0x80000000 and alternating bytes
    (``bit4_words``); the inverse takes their planes."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    rng = np.random.default_rng(17)
    cases = []
    for chunks in (1, 2, 3, 6104):
        words = torch.from_numpy(
            _partition_models().bit4_words(rng, chunks).view(np.int32)).cuda()
        if name == "bitunshuffle_u32":
            words = ref.bitshuffle_ref(words)
        cases.append((f"adversarial words, {chunks} chunks", (words,)))
    return cases


def signature_timing(name: str, kern, rec, keys, card: str) -> list:
    """The kernel's device time per launch on the first operands of every
    signature the paths recorded, beside its bound."""
    rows = []
    for k in keys:
        args = rec.calls[k][0]
        out = kern(*args)
        traced = device_ms(lambda: kern(*args), 20)
        ms = traced[0] if traced else queued_ms(lambda: kern(*args), 20)
        b_ms, b_by = bound_ms(name, args, out)
        rows.append({"signature": repr(k[1:]), "ms": ms, "bound_ms": b_ms,
                     "bound_by": b_by,
                     "timed_by": "profiler device time" if traced
                     else "CUDA events, queued"})
        log(f"kernel {name} on {k[1:]}: {ms:.4f} ms, bound {b_ms:.4f} ms by "
            f"{b_by}; card {card}")
    return rows


def kernel_phase(rec, launches: dict, card: str):
    import torch

    from repro_torch import kernels
    from repro_torch.core import quantize, topology
    from repro_torch.kernels import (
        bitshuffle_kernel,
        fused_decode,
        fused_encode,
        ref,
        rze_kernel,
        subbin_sweep,
    )

    tile_solve = (subbin_sweep.solve_tiles_blockwise,
                  subbin_sweep.solve_tiles_blockwise_plain)
    impl = {
        "solve_tiles_blockwise": tile_solve,
        "solve_tiles_blockwise_ordered32": tile_solve,
        "solve_tiles_blockwise_64": tile_solve,
        "quantize_ff32": (rec.real["quantize_ff32"], ref.quantize_ff32_ref),
        "dequantize_ff32": (rec.real["dequantize_ff32"], ref.dequantize_ff32_ref),
        "encode_ints_fused": (fused_encode.encode_ints_fused,
                              fused_encode.encode_ints_plain),
        "decode_tiles_fused": (fused_decode.decode_tiles_fused,
                               fused_decode.decode_tiles_plain),
        "encode_values_fused": (fused_encode.encode_values_fused,
                                fused_encode.encode_values_plain),
        "decode_tiles_fused_nosub": (fused_decode.decode_tiles_fused,
                                     fused_decode.decode_tiles_plain),
        "solve_blockwise": (subbin_sweep.solve_blockwise,
                            subbin_sweep.solve_blockwise_plain),
        "bitshuffle_u32": (bitshuffle_kernel.bitshuffle_u32, ref.bitshuffle_ref),
        "bitunshuffle_u32": (bitshuffle_kernel.bitunshuffle_u32,
                             ref.bitunshuffle_ref),
        "rze_bitmap_u32": (rze_kernel.rze_bitmap_u32, ref.rze_bitmap_ref),
    }
    # the plain band solve's relaxations of all bands (its Jacobi
    # launches, the PR-13 kernel's launches that did work), logged
    relaxations = [0]
    relax_bands = subbin_sweep._relax_bands

    def counted_relax(*a):
        relaxations[0] += 1
        return relax_bands(*a)

    subbin_sweep._relax_bands = counted_relax
    max_passes = subbin_sweep.BAND_MAX_PASSES
    rows = []
    for name, (source, replaces) in KERNELS.items():
        kern, plain = impl[name]
        keys = [k for k in rec.calls if k[0] == name]
        check(keys, f"{name}: no recorded call")
        if name == "solve_blockwise":
            cases = band_cases(rec, topology, quantize)
        else:
            cases = [(repr(k[1:]), args) for k in keys for args in rec.calls[k]]
            if name in FUSED:
                cases += fused_cases(name)
            elif name in ("bitshuffle_u32", "bitunshuffle_u32"):
                cases += bit4_cases(name)
        checks, err, work = [], 0.0, {}
        for label, args, *cap in cases:
            relaxations[0] = 0
            kernels.reset_launches()
            if cap and cap[0]:
                subbin_sweep.BAND_MAX_PASSES = cap[0]
            try:
                got = kern(*args)
            finally:
                subbin_sweep.BAND_MAX_PASSES = max_passes
            n_launch = sum(kernels.LAUNCHES.values())
            want = plain(*args)
            torch.cuda.synchronize()
            work[label] = relaxations[0]
            pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            same = all(_same(a, b)[0] for a, b in pairs)
            e = max(_same(a, b)[1] for a, b in pairs)
            err = max(err, e)
            checks.append({"signature": label, "match": same, "max_abs_err": e,
                           "launches": n_launch,
                           **({"sweeps": got[1], "relaxations": work[label]}
                              if name == "solve_blockwise" else {})})
            check(same, f"{name}: kernel differs from plain on {label} "
                        f"(max abs err {e})")
        if name == "bitunshuffle_u32":
            # the round trip through both kernels
            for label, (words,) in bit4_cases("bitshuffle_u32"):
                same = torch.equal(kern(impl["bitshuffle_u32"][0](words)), words)
                checks.append({"signature": f"round trip, {label}",
                               "match": same, "max_abs_err": 0.0})
                check(same, f"bitunshuffle(bitshuffle(w)) != w on {label}")
        if name == "solve_blockwise":
            # the cap of 8 passes must have stopped the chain's tile
            n_cap = {c["signature"]: c["launches"] for c in checks
                     if "in-tile chain" in c["signature"]}
            check(n_cap["24x16x64 in-tile chain, cap 8 passes"]
                  > n_cap["24x16x64 in-tile chain"],
                  f"solve_blockwise: a cap of 8 passes added no launch {n_cap}")
        # time the first operands: the main path's f32 field
        label, args = cases[0][:2]
        out = kern(*args)
        extra = {}
        if name == "solve_blockwise":
            # one call is the whole solve: many launches and host reads
            ms, timed_by = cuda_ms(lambda: kern(*args), 3), "CUDA events, whole solve"
            events_ms = ms
            traced = device_ms(lambda: kern(*args), 1, "band_sweep")
            extra = {"relaxations": work[label], "sweeps": out[1],
                     "band_kernel_ms_per_launch": traced and traced[0],
                     "band_launches_per_solve": traced and traced[1],
                     "miranda_whole": band_whole_timing(kern, max(
                         (rec.calls[k][0] for k in keys),
                         key=lambda a: a[0].numel()), card)}
        else:
            traced = device_ms(lambda: kern(*args), 20)
            if traced is None:  # the trace held no kernel event
                ms = queued_ms(lambda: kern(*args), 20)
                timed_by = "CUDA events, queued behind a spin kernel"
            else:
                ms, timed_by = traced[0], f"profiler device time, {traced[1]} launches"
            events_ms = cuda_ms(lambda: kern(*args), 20)
            if name.startswith("solve_tiles_blockwise"):
                extra = {"rounds": solve_rounds_timing(rec, name, card)}
            if name in FUSED:
                extra = {"per_signature": signature_timing(name, kern, rec,
                                                           keys, card)}
        plain_ms = cuda_ms(lambda: plain(*args), 1)
        library_ms = None
        if name == "rze_bitmap_u32":  # the counts alone, not the bitmap
            library_ms = cuda_ms(lambda: torch.count_nonzero(args[0], dim=1), 20)
            extra["library_call"] = "torch.count_nonzero(words, dim=1): counts only"
        b_ms, b_by = bound_ms(name, args, out)
        counter = COUNTER.get(name, name)
        by_path = {p: c[counter] for p, c in launches.items()
                   if c.get(counter) and row_paths(name, p)}
        check(by_path, f"{name}: no path launched it")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "ms_timed_by": timed_by, "events_ms": events_ms,
            "match": True, "timed_signature": label, "checks": checks, **extra,
        })
        log(f"kernel {name}: {len(checks)} checks bit-equal, {ms:.4f} ms "
            f"({timed_by}; {events_ms:.4f} ms by CUDA events), plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}, library "
            f"{library_ms}, on {label}; launches {by_path}"
            + (f"; {extra}" if extra and "per_signature" not in extra else ""))
    subbin_sweep._relax_bands = relax_bands
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

    from repro_torch import core, tda, temporal
    from repro_torch import engine as eng
    from repro_torch import kernels
    from repro_torch.core import bitstream, quantize, subbin, topology
    from repro_torch.data.fields import (
        FIELD_GENERATORS,
        make_field_sequence,
        make_scientific_field,
    )
    from repro_torch.engine import device as device_mod
    from repro_torch.engine import executor
    from repro_torch.kernels import (
        bitshuffle_kernel,
        fused_decode,
        ops,
        quantize_kernel,
        rze_kernel,
        subbin_sweep,
    )

    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules), "jax/repro imported")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_s: dict[str, float] = {}
    last = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    # ---- 1. build
    build_s = kernels.build()
    log(f"kernels built in {build_s:.1f} s")
    phase_done("1 build")

    rec = Recorder(device_mod, (subbin_sweep, bitshuffle_kernel, rze_kernel),
                   (quantize_kernel, fused_decode))
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
            f"{r['n_sweeps']} sweeps; download {r['d2h_ratio']:.4f}x the "
            f"container (word-level form {r['word_form_d2h_ratio']:.4f}x, "
            f"staged {r['staged_d2h_ratio']:.4f}x); card {card}")
    phase_done("2 main path")

    # ---- 2d. the whole-field (v1) compressor at full size, its decode
    # held to the tiled engine's decode of the same field
    v1_runs = [v1_path(*cell, core, kernels, topology, field, launches,
                       arrays[2])
               for cell, (arrays, _) in zip((ISABEL, MIRANDA), runs)]
    v1_sections_reencode(v1_runs[0][0][1], v1_runs[0][1])
    for arrays, info in v1_runs:
        warm_timing(*arrays, core, info, container_version=1)
        results.append(info)
        log(f"full size {info['field']}: ratio {info['ratio']:.3f}, compress "
            f"{info['compress_MB_s']:.1f} MB/s, decompress "
            f"{info['decompress_MB_s']:.1f} MB/s (warm medians of 3), "
            f"{info['n_sweeps']} global band sweeps; card {card}")
    phase_done("2d v1")

    # ---- 2b. plain path at full size
    plain_runs = [plain_path(*cell, eng, executor, kernels, field, launches)
                  for cell in (ISABEL, MIRANDA)]
    for arrays, info in plain_runs:
        warm_timing(*arrays, eng, info, preserve_order=False)
        results.append(info)
        log(f"full size {info['field']}: ratio {info['ratio']:.3f}, compress "
            f"{info['compress_MB_s']:.1f} MB/s, decompress "
            f"{info['decompress_MB_s']:.1f} MB/s (warm medians of 3); download "
            f"{info['d2h_ratio']:.4f}x the container (word-level form "
            f"{info['word_form_d2h_ratio']:.4f}x, staged "
            f"{info['staged_d2h_ratio']:.4f}x); card {card}")
    phase_done("2b plain path")

    # ---- 2e. topology-adaptive error bounds at full size
    adaptive_runs = [adaptive_path(*cell, eng, executor, kernels, topology,
                                   tda, field, launches, rec, arrays[1])
                     for cell, (arrays, _) in zip((ISABEL, MIRANDA), runs)]
    miranda = field(*MIRANDA[:2], np.dtype(MIRANDA[2]), seed=0)
    adaptive_runs.append(adaptive_path(
        *MIRANDA, eng, executor, kernels, topology, tda, field, launches, rec,
        eng.compress(miranda, EB_MIXED), eb=EB_MIXED, mixed=True))
    del miranda
    for arrays, info in adaptive_runs:
        warm_timing(*arrays, eng, info, adaptive_eb="tda")
        results.append(info)
        log(f"full size {info['field']}: ratio {info['ratio']:.3f}, compress "
            f"{info['compress_MB_s']:.1f} MB/s, decompress "
            f"{info['decompress_MB_s']:.1f} MB/s (warm medians of 3), "
            f"{info['halo_rounds']} halo rounds; card {card}")
    phase_done("2e adaptive")

    # ---- 2f. the FF32 contract at full size
    ff32 = ff32_path(*ISABEL, ops, subbin, quantize, tda, kernels, field,
                     launches)
    phase_done("2f ff32")

    # ---- 2g. temporal chains at full size
    chains, chain_profiles = [], {}
    isabel_frames = chain_frames("advect", *ISABEL, 6, field)
    for label, evo, name, shape, dtype, n, interval, kw in CHAIN_CELLS:
        frames = (isabel_frames[:n] if name == ISABEL[0]
                  else chain_frames(evo, name, shape, dtype, n, field))
        blob, y, info = chain_path(label, frames, interval, kw, temporal, eng,
                                   executor, kernels, topology, tda, launches,
                                   rec)
        # the run's time limit leaves room for one timed pass a chain and
        # a device profile of the isabel chains only (miranda's is 1.2 GB,
        # ~15 s a pass); the host's shares of the first chain's compress
        # only: the decompress's are the snapshot decode's section parsing
        chain_timing(frames, interval, kw, blob, y, temporal, info, reps=1)
        if name == ISABEL[0]:
            chain_profiles[label] = profile_calls({
                "compress": lambda: temporal.compress_chain(
                    frames, EB, keyframe_interval=interval, **kw),
                "decompress": lambda: temporal.decompress_chain(blob)},
                host=("compress",) if label == CHAIN_CELLS[0][0] else ())
        if label == CHAIN_CELLS[0][0]:
            info["decode_stages"] = chain_decode_stages(blob, temporal, card)
            chain_cut_agreement(frames, temporal, info)
        chains.append(info)
        results.append(info)
        log(f"full size {label}: ratio {info['ratio']:.3f} "
            f"({info['ratio_vs_snapshots']:.4f}x the snapshots'), compress "
            f"{info['compress_MB_s']:.1f} MB/s, decompress "
            f"{info['decompress_MB_s']:.1f} MB/s (one warm pass, raw MB "
            f"of all {info['frames']} frames); card {card}")
        del frames, blob, y
    phase_done("2g chains")

    # ---- 2h. the serving stack at full size: store, service, trace
    serving, single_chain = serving_phase(*runs[0][0], isabel_frames, eng,
                                          executor, kernels, temporal,
                                          launches, card)
    phase_done("2h serving")

    # ---- 2i. the sharded store cluster on the card
    cluster = cluster_phase(*runs[0][0], isabel_frames, single_chain, eng,
                            kernels, launches, serving["store"]["roi_cold_s"],
                            card)
    del isabel_frames, single_chain
    phase_done("2i cluster")

    # ---- 2j. distributed compression, the checkpoint, the baselines
    distributed = distributed_phase(
        *runs[0][0], runs[0][1], plain_runs[0][1]["ratio"],
        field(*MIRANDA[:2], np.dtype(MIRANDA[2]), seed=0), eng, kernels,
        launches, card)
    phase_done("2j distributed")

    # ---- 2k. LM serving: qwen2.5-3b at full size, the card against the
    # CPU, the KV offload through the service
    lm = lm_phase(eng, kernels, launches, card)
    phase_done("2k LM serving")
    log("launches by path: " + json.dumps(launches))
    log(json.dumps({"full_size": results, "launches_by_path": launches}))
    profiles = {f"{cell[0]}{kind}": profile(*cell, api, field, **kw)
                for kind, api, kw in (("", eng, {}),
                                      (" plain", eng, {"preserve_order": False}),
                                      (" v1", core, {"container_version": 1}),
                                      (" adaptive", eng, {"adaptive_eb": "tda"}))
                for cell in ((ISABEL, MIRANDA) if kind == "" else (ISABEL,))}
    profiles.update(chain_profiles)
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
    for (arrays, info), cpu_compress, (v1_arrays, _) in zip(
            runs, (True, False), v1_runs):
        full_size_agreement(*arrays, eng, info, cpu_compress, v1_arrays[2])
    for (arrays, info), cpu_compress in zip(plain_runs, (True, False)):
        plain_agreement(*arrays, eng, info, cpu_compress)
    for arrays, info in (adaptive_runs[0], adaptive_runs[2]):
        adaptive_cpu_agreement(*arrays, eng, info)
    # Miranda's containers at the main path's bound, on a cut: the f64
    # field's 64-bit lane and its real stream widths against the CPU
    cut_agreement(runs[1][0][0], eng, runs[1][1])
    cut_agreement(adaptive_runs[1][0][0], eng, adaptive_runs[1][1],
                  adaptive_eb="tda")
    phase_done("profiles and CPU agreement")

    # ---- 2c. region reads of the full-size containers
    roi = roi_phase({runs[0][1]["field"]: runs[0][0][1],
                     plain_runs[0][1]["field"]: plain_runs[0][0][1],
                     runs[1][1]["field"]: runs[1][0][1]}, eng, executor)
    del runs, plain_runs, v1_runs, adaptive_runs
    phase_done("2c ROI")

    # ---- 3. width and tile-shape runs (same entry points, not counted):
    # the full-size fields again at bounds that need int32 / int64 bins
    # (isabel's also on the plain path: the value encode's int32 store),
    # 1-D and 2-D fields on their plan tiles, an adaptive 1-D f64 field
    # (the 64-bit ordered lane on the (1, 1, 4096) tile, whose haloed
    # state does not fit shared memory; its bound is the loosest rung's),
    # and a strictly decreasing run of 40000 floats inside one bin, whose
    # subbins count down from 39999 and so need the int32 subbin section
    n = 40000
    chain = (1.0 + (n - np.arange(n)) * 2.0**-23).astype(np.float32)
    isabel = field(*ISABEL[:2], np.dtype(ISABEL[2]), seed=0)
    waves64 = field("waves", (1 << 20,), np.dtype("float64"), seed=0)
    # five noisy 4096-cell tiles and a smooth ramp, each boundary's left
    # cell just above its right one: the ladder's rounds leave anchor
    # inversions, whose ordered-space climbs need 8-byte subbin sections
    rng = np.random.default_rng(0)
    stair = np.concatenate([rng.standard_normal(4096) for _ in range(5)]
                           + [np.linspace(0.0, 0.05, 4096)])
    for t in range(1, 6):
        w = rng.uniform(-0.5, 0.5)
        stair[t * 4096], stair[t * 4096 - 1] = w, w + 1e-9
    widths = [(f"{ISABEL[0]}{ISABEL[1]}", isabel, 1e-6, "noa", True, {}),
              (f"{ISABEL[0]}{ISABEL[1]} plain", isabel, 1e-6, "noa", False, {}),
              (f"{MIRANDA[0]}{MIRANDA[1]}", field(*MIRANDA[:2], np.dtype(MIRANDA[2]), seed=0), 1e-11, "noa", True, {}),
              ("waves(1048576,)", field("waves", (1 << 20,), np.dtype("float32"), seed=0), 1e-2, "noa", True, {}),
              ("waves(1048576,) adaptive", waves64, 1e-2, "noa", True, {"adaptive_eb": "tda"}),
              ("staircase(24576,) adaptive", stair, 1e-2, "noa", True, {"adaptive_eb": "tda"}),
              ("front(2048, 2048)", field("front", (2048, 2048), np.dtype("float64"), seed=0), 1e-2, "noa", True, {}),
              ("decreasing-run(40000,)", chain, 1.0, "abs", True, {})]
    for label, x, eb, mode, order, kw in widths:
        rec.ordered = bool(kw)
        blob = eng.compress(x, eb, mode=mode, preserve_order=order, **kw)
        rec.ordered = False
        y = eng.decompress(blob)
        bound = eb if mode == "abs" else eb * (float(x.max()) - float(x.min()))
        if kw:
            bound *= 2.0**bitstream.EB_LADDER_K_MAX
        err = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
        check(err <= bound, f"width run {label}@{eb}: bound violated")
        words = bitstream.read_container_v2(blob).stream_words()
        log(f"width run {label}/{x.dtype} eb {eb} {mode}: ratio "
            f"{x.nbytes / len(blob):.3f}, section words (bins, subbins) {words}")
        if label.startswith("staircase"):
            check(words[1] == 8, "the staircase did not reach 8-byte subbins")
            check(blob == eng.compress(x, eb, adaptive_eb="tda", device="cpu"),
                  "the staircase's container differs on the CPU")
    check(words[1] == 4, "the decreasing run did not reach int32 subbins")
    # the decreasing run's container against the reference's, computed
    # once on the CPU (its 40000-sweep solve takes a minute there)
    want = json.loads((SRC / "repro_torch" / "data"
                       / "reference_hashes.json").read_text())
    check(hashlib.sha256(blob).hexdigest()
          == want["decreasing-run(40000,)/float32/abs/1.0"],
          "the decreasing run's container differs from the reference's")
    log("width run decreasing-run(40000,): container equals the reference's "
        "(committed sha256)")
    tiny_bound_runs(eng, kernels, ops)
    # a field falling in linear index inside one bin on 4x4x4 plan tiles:
    # one chain through every tile; its round-2 batch (the active tiles)
    # goes to the kernel-vs-plain phase
    ramp = -np.arange(64 * 64 * 256, dtype=np.float64).reshape(64, 64, 256) * 1e-9
    rec.tag = "cross-tile ramp"
    blob = eng.compress(ramp, 1.0, mode="abs")
    rec.tag = ""
    solved = solved_tiles("ramp(64, 64, 256)")
    check(len(solved) >= 4 and solved[-1] < solved[0],
          f"the cross-tile ramp's rounds solved {solved} tiles")
    y = eng.decompress(blob)
    check(y.tobytes() == eng.decompress(blob, device="cpu").tobytes(),
          "the cross-tile ramp decodes to other values on the CPU")
    check(order_preserved(torch.from_numpy(ramp).cuda(),
                          torch.from_numpy(y).cuda(), topology),
          "the cross-tile ramp's decode breaks the order")
    check(any(k[0] == "encode_values_fused" and k[-1] == torch.int32
              for k in rec.calls), "the value encode never stored int32 bins")
    check(any(k[0] == "solve_tiles_blockwise_64" and k[3][0] == (3, 3, 4098)
              for k in rec.calls), "the 64-bit lane never ran the 1-D tile")
    phase_done("3 width runs")

    # ---- 4. kernels against plain versions on the recorded operands
    rows = kernel_phase(rec, launches, card)
    phase_done("4 kernels")

    # ---- 5. determinism manifests on the card: the order-preserving
    # containers (default and fused encode path) and the plain ones
    manifest = json.loads(
        (ROOT / "benchmarks" / "baselines" / "determinism_hashes.json").read_text())
    plain_hashes = json.loads(
        (SRC / "repro_torch" / "data" / "plain_hashes.json").read_text())
    n = 0
    for name in sorted(FIELD_GENERATORS):
        for shape in ((13, 11, 9), (40, 28), (500,)):
            for dtype in ("float32", "float64"):
                case = f"{name}/{'x'.join(map(str, shape))}/{dtype}"
                x = make_scientific_field(name, shape, np.dtype(dtype), seed=5)
                for want, kw in ((manifest, {}),
                                 (manifest, {"encode_path": "fused"}),
                                 (plain_hashes, {"preserve_order": False}),
                                 (plain_hashes, {"preserve_order": False,
                                                 "encode_path": "fused"})):
                    blob = eng.compress(x, EB, **kw)
                    check(hashlib.sha256(blob).hexdigest() == want[case],
                          f"{case} {kw}: container hash differs from the manifest")
                    check(within_bound(x, eng.decompress(blob), EB),
                          f"{case} {kw}: round trip exceeds the bound")
                v1 = core.compress(x, EB, container_version=1)
                check(v1 == core.compress(x, EB, container_version=1,
                                          device="cpu"),
                      f"{case}: the card's v1 container differs from the CPU's")
                check(core.decompress(v1).tobytes()
                      == eng.decompress(eng.compress(x, EB)).tobytes(),
                      f"{case}: the v1 decode differs from the tiled decode")
                n += 1
    check(n == 24 and len(plain_hashes) == 24, "manifest cases missing")
    n_adaptive = 0
    loose = 2.0**bitstream.EB_LADDER_K_MAX
    for name in sorted(FIELD_GENERATORS):
        for dtype in ("float32", "float64"):
            case = f"adaptive/{name}/{dtype}"
            x = make_scientific_field(name, (17, 14, 12), np.dtype(dtype), seed=5)
            for solver in device_mod.SOLVERS:
                blob = eng.compress(x, EB, solver=solver, adaptive_eb="tda")
                check(hashlib.sha256(blob).hexdigest() == manifest[case],
                      f"{case} solver {solver}: container hash differs from "
                      "the manifest")
            bound = EB * loose * (float(x.max()) - float(x.min()))
            err = float(np.abs(x.astype(np.float64)
                               - eng.decompress(blob).astype(np.float64)).max())
            check(err <= bound, f"{case}: round trip exceeds the ladder bound")
            n_adaptive += 1
    check(n_adaptive == 8, "adaptive manifest cases missing")
    # the chain cases: 5 frames at keyframe interval 2 (both frame kinds
    # and a mid-chain keyframe), (13, 11, 9) uniform, (17, 14, 12) adaptive
    n_chain = 0
    for case in sorted(k for k in manifest if k.startswith("chain")):
        parts = case.split("/")
        adaptive = parts[0] == "chain-adaptive"
        evo, base, dtype = (parts[1], "gaussians", parts[2]) if adaptive \
            else parts[1:]
        frames = make_field_sequence(
            evo, base, (17, 14, 12) if adaptive else (13, 11, 9), 5,
            np.dtype(dtype), seed=5)
        kw = {"adaptive_eb": "tda"} if adaptive else {}
        blob = temporal.compress_chain(frames, EB, keyframe_interval=2, **kw)
        check(hashlib.sha256(blob).hexdigest() == manifest[case],
              f"{case}: chain hash differs from the manifest")
        y = temporal.decompress_chain(blob)
        bound = EB * (loose if adaptive else 1.0)
        check(all(within_bound(f, y[t], bound) for t, f in enumerate(frames)),
              f"{case}: a frame's round trip exceeds its bound")
        n_chain += 1
    check(n_chain == 12, "chain manifest cases missing")
    log(f"determinism: {n}/24 manifest hashes and {n}/24 plain hashes "
        "reproduced on the card, each with the default and the fused encode "
        f"path; {n}/24 v1 containers equal the CPU's and decode to the tiled "
        f"decode; {n_adaptive}/8 adaptive hashes under each of "
        f"{len(device_mod.SOLVERS)} solver values; {n_chain}/12 chain hashes")
    phase_done("5 determinism")
    log("seconds per phase: " + json.dumps(phase_s))

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "full_size": results,
         "ff32": ff32, "chains": chains, "profiles": profiles, "roi": roi,
         "serving": serving, "cluster": cluster, "distributed": distributed,
         "lm": lm, "phase_s": phase_s,
         "launches_by_path": launches, "kernels": rows,
         "seconds": time.perf_counter() - T0}, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
