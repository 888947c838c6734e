"""Frame-chain compression (port of ``repro.temporal.chain``).

A chain predicts frame ``t``'s quantized bin grid from the decoded bins
of frame ``t-1`` (the encoder's own bins: the bins stream is lossless,
so the predictor never drifts) and encodes only the bin residual,
zigzag-encoded, through the engine's BIT/RZE stages (kernel 2).  The
subbin local-order solve (kernel 1) still runs on every frame's own bins
and values, so every decoded frame keeps full local order.  Chain bytes
equal the reference's.

Residency: the previous frame's bins stay on the device between frames
(``device.residual_tiles`` / ``device.accumulate_bins``), so a chain
costs one tile upload and one stream download per frame per group.
Frames at one time step of concurrent chains share resident batches,
grouped by (dtype, tile shape, frame kind, stored width, adaptive);
group composition never changes a chain's bytes.

Every frame of a chain shares one bin width: ``mode="noa"`` takes the
minimum of the per-frame NOA bounds.  Keyframes (every
``keyframe_interval`` frames) are encoded like v2 snapshots, so
``decompress_frame(t)`` replays at most one keyframe and the residual
run after it.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the kernels' plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codecs.transforms import NP_UNSIGNED
from ..core import bitstream
from ..core.nonfinite import decode_nonfinite, encode_nonfinite
from ..core.quantize import abs_bound_from_mode, bin_dtype_for, effective_eps
from ..engine import device as _device
from ..engine.engine import (
    DEFAULT_PLAN,
    _check_eps,
    _not_in_slice,
    _serialize_tile_sections,
    _store_bin_dtype,
    _validate,
    assemble_interiors,
    container_layout,
    resolve_device,
)
from ..engine.executor import (
    _CHUNK_WORDS,
    _TORCH_DTYPE,
    CAPACITY_FLOOR,
    TRANSFER_COUNTS,
    _fill_rows,
    default_executor,
    resident_capacity,
)
from ..engine.plan import (
    CompressionPlan,
    TileLayout,
    extract_halo_tiles,
    padded_with_border,
)
from ..tda.adaptive import ADAPTIVE_EB_MODES, ladder_indices, tighten_ladder

FLAG_ORDER_PRESERVING = bitstream.FLAG_ORDER_PRESERVING
FLAG_HAS_NONFINITE = bitstream.FLAG_HAS_NONFINITE
FLAG_ADAPTIVE_EB = bitstream.FLAG_ADAPTIVE_EB

DEFAULT_KEYFRAME_INTERVAL = 8


@dataclass
class ChainStats:
    """Size accounting for one compressed chain."""

    raw_bytes: int
    total_bytes: int
    bins_bytes: int
    subbin_bytes: int
    header_bytes: int
    n_frames: int
    n_keyframes: int
    n_sweeps: int
    eps_abs: float

    @property
    def ratio(self) -> float:
        return self.raw_bytes / self.total_bytes


def _normalize_interval(keyframe_interval) -> int:
    """None/0 -> 0 (only frame 0 is a keyframe); else the stride."""
    if keyframe_interval is None:
        return 0
    k = int(keyframe_interval)
    if k < 0:
        raise ValueError("keyframe_interval must be >= 0 (0/None = only "
                         "frame 0)")
    return k


def _frame_kind(t: int, interval: int) -> int:
    if t == 0 or (interval and t % interval == 0):
        return bitstream.FRAME_KEY
    return bitstream.FRAME_RESIDUAL


def _eps_tiles(r) -> np.ndarray:
    """(n_tiles,) effective per-tile eps of a chain (ladder-scaled when
    adaptive, uniform otherwise), shared by every frame."""
    if not r.adaptive:
        return np.full(r.layout.n_tiles, r.eps_eff, np.float64)
    return r.eps_eff * np.exp2(-r.ladder.astype(np.float64))


class _Chain:
    """One chain moving through a compress_chains call."""

    def __init__(self, frames, eb, mode, plan, keyframe_interval,
                 adaptive_eb: str, dev: torch.device):
        frames = [np.asarray(f) for f in frames]
        if not frames:
            raise ValueError("a chain needs at least one frame")
        shape, dtype = frames[0].shape, frames[0].dtype
        for f in frames:
            _validate(f, eb)
            if f.shape != shape or f.dtype != dtype:
                raise ValueError(
                    "all frames of a chain must share one shape and dtype "
                    f"(got {f.shape}/{f.dtype} after {shape}/{dtype})"
                )
        self.eb = float(eb)
        self.mode = mode
        self.interval = _normalize_interval(keyframe_interval)
        self.filled: list[np.ndarray] = []
        self.nonfinite: list[bytes | None] = []
        for f in frames:
            nf = None
            if not np.isfinite(f).all():
                f, nf = encode_nonfinite(f)
            self.filled.append(f)
            self.nonfinite.append(nf)
        # one bin width for the whole chain: the tightest per-frame bound
        self.eps_abs = min(abs_bound_from_mode(f, eb, mode)
                           for f in self.filled)
        for f in self.filled:
            _check_eps(f, self.eps_abs)
        self.layout: TileLayout = plan.layout_for(shape)
        self.adaptive = adaptive_eb == "tda"
        self.ladder = None
        if self.adaptive:
            # the chain-wide ladder: the tightest rung any frame needs,
            # then re-tightened against every frame to a fixpoint (the
            # elementwise max can make cross-eps tile boundaries no single
            # frame's ladder had)
            ladder = np.maximum.reduce(
                [ladder_indices(f, self.layout, self.eps_abs, device=dev)
                 for f in self.filled])
            for _ in range(bitstream.EB_LADDER_K_MAX + 1):
                prev = ladder
                for f in self.filled:
                    ladder = tighten_ladder(f, self.layout, ladder,
                                            self.eps_abs, device=dev)
                if np.array_equal(ladder, prev):
                    break
            self.ladder = ladder
            self.eps_abs = float(self.eps_abs
                                 * 2.0**bitstream.EB_LADDER_K_MAX)
        self.eps_eff = effective_eps(self.eps_abs)
        eps_tight = self.eps_eff * (
            2.0**-bitstream.EB_LADDER_K_MAX if self.adaptive else 1.0)
        self.max_bin = [
            float(np.max(np.abs(f), initial=0.0)) / eps_tight + 4
            for f in self.filled
        ]
        self.dtype = np.dtype(dtype)
        self.shape = shape
        self.prev_bins = None          # device (n_tiles, *tile), bin dtype
        self.sections: list[list[tuple[bytes, bytes]]] = [None] * len(frames)
        self.sweeps = 0

    @property
    def n_frames(self) -> int:
        return len(self.filled)

    def kind(self, t: int) -> int:
        return _frame_kind(t, self.interval)

    def bins_store(self, t: int) -> np.dtype:
        """Stored word width of frame t's bins stream, from host-side
        bounds only (so it never depends on batching or the solver): a
        residual is bounded by the two adjacent frames' bin bounds."""
        if self.kind(t) == bitstream.FRAME_KEY:
            return _store_bin_dtype(self.max_bin[t], self.dtype)
        return _store_bin_dtype(self.max_bin[t] + self.max_bin[t - 1],
                                self.dtype)

    def eps_tiles(self) -> np.ndarray:
        return _eps_tiles(self)


def compress_chains(
    chains,
    eb,
    mode: str = "noa",
    preserve_order: bool = True,
    solver: str = "auto",
    plan: CompressionPlan | None = None,
    keyframe_interval=DEFAULT_KEYFRAME_INTERVAL,
    return_stats: bool = False,
    put=None,
    group_cb=None,
    encode_path: str = "auto",
    adaptive_eb: str = "off",
    device="cuda",
):
    """Compress a batch of frame sequences into v3 chain containers.

    ``chains`` is a sequence of frame sequences (each frame a 1/2/3-D
    float32/float64 array; the frames of one chain share shape and
    dtype, different chains may mix).  ``eb`` and ``keyframe_interval``
    are scalars or per-chain sequences.  ``solver`` takes the
    reference's values (every schedule gives the same bytes; the tile
    solve runs kernel 1); ``encode_path`` picks the download form, as
    in ``engine.compress``.

    Returns a list of blobs, or (blobs, stats) when ``return_stats``.
    """
    if solver not in _device.SOLVERS:
        raise ValueError(f"unknown solver method {solver!r}")
    if adaptive_eb not in ADAPTIVE_EB_MODES:
        raise ValueError(f"unknown adaptive_eb mode {adaptive_eb!r} "
                         f"(expected one of {ADAPTIVE_EB_MODES})")
    if adaptive_eb != "off" and not preserve_order:
        raise ValueError("adaptive_eb requires preserve_order=True (the "
                         "ladder exists to protect topology)")
    if put is not None:
        _not_in_slice("put", 13, "distributed")
    if group_cb is not None:
        _not_in_slice("group_cb", 12, "serving stack")
    dev = resolve_device(device)
    plan = plan or DEFAULT_PLAN
    chains = list(chains)
    if not chains:
        return ([], []) if return_stats else []
    ebs = list(eb) if np.ndim(eb) else [eb] * len(chains)
    if len(ebs) != len(chains):
        raise ValueError("eb must be a scalar or one bound per chain")
    if isinstance(keyframe_interval, (list, tuple)):
        intervals = list(keyframe_interval)
        if len(intervals) != len(chains):
            raise ValueError("keyframe_interval must be a scalar or one "
                             "stride per chain")
    else:
        intervals = [keyframe_interval] * len(chains)
    reqs = [_Chain(c, e, mode, plan, k, adaptive_eb, dev)
            for c, e, k in zip(chains, ebs, intervals)]
    ex = default_executor(plan, dev, encode_path)

    for t in range(max(r.n_frames for r in reqs)):
        groups: dict[tuple, list[_Chain]] = {}
        for r in reqs:
            if t < r.n_frames:
                groups.setdefault(
                    (r.dtype, r.layout.tile, r.kind(t), r.bins_store(t),
                     r.adaptive), []).append(r)
        for (dtype, _tile, kind, store, _adaptive), members in groups.items():
            _compress_chain_step(members, t, kind, store, dtype,
                                 preserve_order, ex)

    blobs = [_serialize_chain(r, preserve_order) for r in reqs]
    if return_stats:
        return blobs, [_chain_stats(r, b) for r, b in zip(reqs, blobs)]
    return blobs


def _compress_chain_step(members, t, kind, store, dtype, preserve_order, ex):
    """One resident step: frame ``t`` of every chain in one group, on the
    executor (one tile upload per device batch, one stream download).
    The previous step's resident bins predict a residual frame, and this
    frame's bins stay resident as the next step's predictor."""
    nan = np.asarray(np.nan, dtype)
    x_tiles, eps_tiles, ranges = [], [], []
    n_total = 0
    for r in members:
        arr3 = r.filled[t].reshape(r.layout.canonical)
        x_pb = padded_with_border(arr3, r.layout, nan)
        x_tiles.append(extract_halo_tiles(x_pb, r.layout))
        eps_tiles.append(r.eps_tiles())
        ranges.append((n_total, n_total + r.layout.n_tiles))
        n_total += r.layout.n_tiles
    prev = None
    if kind == bitstream.FRAME_RESIDUAL:
        prev = [r.prev_bins for r in members]
    gs = ex.compress_tiles(
        np.concatenate(x_tiles), np.concatenate(eps_tiles),
        tuple(r.layout for r in members), dtype, preserve_order,
        bins_store=store, adaptive=members[0].adaptive, prev_bins=prev,
        keep_bins=True)

    bins_sections = _serialize_tile_sections(gs.bins, n_total, gs.bins_cpt)
    if preserve_order:
        sub_sections = _serialize_tile_sections(gs.subs, n_total, gs.subs_cpt)
    else:
        sub_sections = [b""] * n_total
    for r, (lo, hi), bins in zip(members, ranges, gs.bins_resident):
        r.prev_bins = bins  # stays resident for frame t+1
        r.sections[t] = list(zip(bins_sections[lo:hi], sub_sections[lo:hi]))
        if preserve_order:
            local = int(gs.local_sweeps[lo:hi].max(initial=0))
            rounds = int(gs.last_round[lo:hi].max(initial=0))
            r.sweeps += local + max(0, rounds - 1)


def _serialize_chain(r: _Chain, preserve_order: bool) -> bytes:
    flags = FLAG_ORDER_PRESERVING if preserve_order else 0
    extra = {}
    if r.adaptive:
        flags |= FLAG_ADAPTIVE_EB
        extra[bitstream.TAG_EB_LADDER] = \
            bitstream.serialize_eb_ladder(r.ladder)
    frames = []
    for t in range(r.n_frames):
        fflags = FLAG_HAS_NONFINITE if r.nonfinite[t] is not None else 0
        payload = bitstream.serialize_frame_payload(
            r.sections[t], r.nonfinite[t] or b"")
        frames.append((r.kind(t), fflags, payload))
    header = bitstream.Header(
        dtype=r.dtype, shape=r.shape, eb_mode=r.mode, eb=r.eb,
        eps_abs=float(r.eps_abs), flags=flags,
    )
    return bitstream.write_container_v3(
        header, r.layout.tile, r.layout.grid, r.interval, frames, extra)


def _chain_stats(r: _Chain, blob: bytes) -> ChainStats:
    bins_bytes = sum(len(b) for tiles in r.sections for b, _ in tiles)
    subbin_bytes = sum(len(s) for tiles in r.sections for _, s in tiles)
    return ChainStats(
        raw_bytes=sum(f.nbytes for f in r.filled),
        total_bytes=len(blob),
        bins_bytes=bins_bytes,
        subbin_bytes=subbin_bytes,
        header_bytes=len(blob) - bins_bytes - subbin_bytes,
        n_frames=r.n_frames,
        n_keyframes=sum(1 for t in range(r.n_frames)
                        if r.kind(t) == bitstream.FRAME_KEY),
        n_sweeps=r.sweeps,
        eps_abs=float(r.eps_abs),
    )


def compress_chain(frames, eb, mode="noa", preserve_order=True, solver="auto",
                   plan=None, keyframe_interval=DEFAULT_KEYFRAME_INTERVAL,
                   return_stats=False, put=None, encode_path="auto",
                   adaptive_eb="off", device="cuda"):
    """Single-chain convenience wrapper over :func:`compress_chains`."""
    out = compress_chains([frames], eb, mode, preserve_order, solver, plan,
                          keyframe_interval, return_stats, put,
                          encode_path=encode_path, adaptive_eb=adaptive_eb,
                          device=device)
    if return_stats:
        blobs, stats = out
        return blobs[0], stats[0]
    return out[0]


# ------------------------------------------------------- appended frames

class _AppendStep:
    """Single-frame stand-in for ``_Chain`` in :func:`_compress_chain_step`,
    so an appended frame runs the same resident step as a frame inside
    ``compress_chains`` (and so gives the same bytes)."""

    def __init__(self, filled, eps_eff, layout, prev_bins, ladder=None):
        self.filled = [filled]
        self.eps_eff = eps_eff
        self.layout = layout
        self.prev_bins = prev_bins
        self.adaptive = ladder is not None
        self.ladder = ladder
        self.sections: list = [None]
        self.sweeps = 0

    def eps_tiles(self) -> np.ndarray:
        return _eps_tiles(self)


def encode_appended_frame(
    frame,
    *,
    eps_abs: float,
    kind: int,
    prev_bins=None,
    prev_max_bin: float = 0.0,
    preserve_order: bool = True,
    solver: str = "auto",
    plan: CompressionPlan | None = None,
    encode_path: str = "auto",
    ladder: np.ndarray | None = None,
    device="cuda",
):
    """Encode ONE frame as the next step of an existing chain.

    ``eps_abs`` is the chain's pinned bin width (an adaptive chain's
    header bound, its loosest rung), ``kind`` the frame kind
    (``bitstream.FRAME_KEY``/``FRAME_RESIDUAL``), and, for a residual
    frame, ``prev_bins`` the previous frame's bins in the engine layout
    (:meth:`ChainDecoder.resident_bins`) with ``prev_max_bin`` its
    host-side bin bound (the stored width follows
    :meth:`_Chain.bins_store`).  ``ladder`` is an adaptive chain's
    committed eb-ladder.  The frame's bytes equal those a whole-chain
    compress writes at that position.  Returns ``(tile_sections,
    nonfinite_sidecar | None, max_bin, sweeps)``.
    """
    if solver not in _device.SOLVERS:
        raise ValueError(f"unknown solver method {solver!r}")
    if kind == bitstream.FRAME_RESIDUAL and prev_bins is None:
        raise ValueError("a residual frame needs the previous frame's bins")
    dev = resolve_device(device)
    plan = plan or DEFAULT_PLAN
    x = np.asarray(frame)
    _validate(x, 1.0)  # the bound is the chain's; check shape and dtype
    nonfinite = None
    if not np.isfinite(x).all():
        x, nonfinite = encode_nonfinite(x)
    adaptive = ladder is not None
    eps_tight_abs = eps_abs * (
        2.0**-bitstream.EB_LADDER_K_MAX if adaptive else 1.0)
    _check_eps(x, eps_tight_abs)
    eps_eff = effective_eps(eps_abs)
    eps_tight = eps_eff * (
        2.0**-bitstream.EB_LADDER_K_MAX if adaptive else 1.0)
    max_bin = float(np.max(np.abs(x), initial=0.0)) / eps_tight + 4
    if kind == bitstream.FRAME_KEY:
        store = _store_bin_dtype(max_bin, np.dtype(x.dtype))
    else:
        store = _store_bin_dtype(max_bin + prev_max_bin, np.dtype(x.dtype))
        prev_bins = torch.as_tensor(prev_bins, device=dev)
    layout = plan.layout_for(x.shape)
    if adaptive and len(ladder) != layout.n_tiles:
        raise ValueError("ladder length does not match the frame's tile grid")
    step = _AppendStep(x, eps_eff, layout, prev_bins,
                       np.asarray(ladder, np.uint8) if adaptive else None)
    _compress_chain_step([step], 0, kind, store, np.dtype(x.dtype),
                         preserve_order, default_executor(plan, dev, encode_path))
    return step.sections[0], nonfinite, max_bin, step.sweeps


# ------------------------------------------------------------ decompress

def _section_word(section: bytes) -> int:
    if len(section) < 9:
        raise ValueError("truncated stream")
    w = section[8]
    if w not in (2, 4, 8):
        raise ValueError("corrupt LOPC container (bad section word size)")
    return int(w)


class ChainDecoder:
    """Sequential bins accumulator over a chain's frames, on ``device``.

    ``step(t)`` decodes frame ``t``'s bins stream and folds it into the
    resident bin state (no subbin decode, no dequantize); ``values(t)``
    also decodes frame ``t``'s subbins and returns the frame's values on
    the host.  ``c`` is anything with the reading surface of
    :class:`~repro_torch.core.bitstream.ContainerV3`.
    ``resident_bins`` is the state in the engine's ``(n_tiles, *tile)``
    layout, the ``prev_bins`` of :func:`encode_appended_frame`.
    """

    def __init__(self, c: bitstream.ContainerV3,
                 plan: CompressionPlan | None = None, device="cuda"):
        plan = plan or DEFAULT_PLAN
        self.c = c
        self.dev = resolve_device(device)
        self.layout = container_layout(c)
        self.order = bool(c.header.flags & FLAG_ORDER_PRESERVING)
        self.eps_eff = effective_eps(c.header.eps_abs)
        self.dtype = np.dtype(c.header.dtype)
        self.bdt = _TORCH_DTYPE[bin_dtype_for(self.dtype)]
        self.capacity = resident_capacity(
            self.layout.n_tiles, max(CAPACITY_FLOOR, plan.batch_tiles))
        self.bins = None     # device (capacity, tile_elems) bin ints
        self.pos = -1        # index of the frame self.bins describes

    def resident_bins(self) -> torch.Tensor:
        """Device ``(n_tiles, *tile)`` bins of the frame ``pos`` points at."""
        n = self.layout.n_tiles
        return self.bins[:n].reshape((n,) + self.layout.tile)

    def _upload_sections(self, sections, word):
        """Fixed-shape (bitmap, packed) signed-twin rows of one frame's
        sections, on the device."""
        chunk_len = _CHUNK_WORDS[word]
        cpt = -(-self.layout.tile_elems // chunk_len)
        udt = NP_UNSIGNED[word]
        bitmap = np.zeros((self.capacity * cpt, chunk_len // (word * 8)), udt)
        packed = np.zeros((self.capacity * cpt, chunk_len), udt)
        for j, section in enumerate(sections):
            _fill_rows(bitmap, packed, section, j * cpt, cpt)
        TRANSFER_COUNTS["h2d_sections"] += 1
        TRANSFER_COUNTS["bytes_h2d"] += bitmap.nbytes + packed.nbytes
        return tuple(torch.from_numpy(a.view(f"<i{word}")).to(self.dev)
                     for a in (bitmap, packed))

    def step(self, t: int):
        """Fold frame ``t``'s bins into the resident state."""
        kind = self.c.entries[t].kind
        if kind == bitstream.FRAME_RESIDUAL and self.pos != t - 1:
            raise ValueError(
                f"chain decode out of order (frame {t} follows {self.pos})")
        tiles, nonfinite = self.c.frame_tiles(t)
        bins_sections = [b for b, _ in tiles]
        word = _section_word(bins_sections[0])
        bitmap, packed = self._upload_sections(bins_sections, word)
        if kind == bitstream.FRAME_KEY:
            self.bins = _device.decode_tiles(
                bitmap, packed, self.layout.tile_elems, "delta", self.bdt)
        else:
            residual = _device.decode_tiles(
                bitmap, packed, self.layout.tile_elems, "zigzag", self.bdt)
            self.bins = _device.accumulate_bins(self.bins, residual)
        self.pos = t
        return tiles, nonfinite

    def values(self, t: int) -> np.ndarray:
        """Decode frame ``t`` fully (step() must be at ``t`` or ``t-1``)."""
        tiles, nonfinite = self.step(t) if self.pos < t else \
            self.c.frame_tiles(t)
        if self.pos != t:
            raise ValueError(
                f"chain decode out of order (frame {t} follows {self.pos})")
        n = self.layout.n_tiles
        eps = np.full(self.capacity, self.eps_eff, np.float64)
        ladder = self.c.eb_ladder()
        eps[:n] = self.eps_eff * np.exp2(-np.asarray(ladder, np.float64))
        if self.order:
            sub_sections = [s for _, s in tiles]
            word = _section_word(sub_sections[0])
            sbitmap, spacked = self._upload_sections(sub_sections, word)
            subs = _device.decode_tiles(
                sbitmap, spacked, self.layout.tile_elems, "raw",
                sbitmap.dtype)
        else:
            subs = torch.zeros_like(self.bins)
        TRANSFER_COUNTS["h2d_aux"] += 1
        TRANSFER_COUNTS["bytes_h2d"] += eps.nbytes
        out = _device.dequantize_tiles(
            self.bins, subs, torch.from_numpy(eps).to(self.dev),
            _TORCH_DTYPE[self.dtype])
        TRANSFER_COUNTS["d2h_values"] += 1
        out_h = out[:n].cpu().numpy()  # the real tiles only
        TRANSFER_COUNTS["bytes_d2h"] += out_h.nbytes
        values = out_h.reshape((n,) + self.layout.tile)
        field = assemble_interiors(values, self.layout, self.c.header.shape)
        if self.c.entries[t].flags & FLAG_HAS_NONFINITE:
            field = decode_nonfinite(nonfinite, field)
        return field


def decompress_chain(blob: bytes, plan: CompressionPlan | None = None,
                     device="cuda") -> np.ndarray:
    """Reconstruct every frame of a v3 chain -> (n_frames, *shape)."""
    c = bitstream.read_container_v3(blob)
    dec = ChainDecoder(c, plan, device)
    return np.stack([dec.values(t) for t in range(c.n_frames)])


def decompress_frame(blob: bytes, t: int, plan: CompressionPlan | None = None,
                     device="cuda") -> np.ndarray:
    """Random-access decode of frame ``t``: replays the bins of the frames
    from ``keyframe_before(t)`` on, and runs the subbin decode and the
    dequantize for frame ``t`` alone."""
    c = bitstream.read_container_v3(blob)
    dec = ChainDecoder(c, plan, device)
    for k in range(c.keyframe_before(t), t):
        dec.step(k)
    return dec.values(t)
