"""Plan/execute compression engine (port of ``repro.engine.engine``).

``compress_many`` turns a mix of 1/2/3-D field requests into shared
fixed-shape tile batches (plan), runs them on the device (execute, see
``executor``), and serializes one v2 container per request, with the
subbin stream (``preserve_order=True``) or without it (the plain path),
and with a per-tile eb ladder (``adaptive_eb="tda"``) or without.
``decompress`` reads a whole field back, ``decompress_roi`` and
``decode_tiles_for_region`` only the tiles a region touches.  Containers
are byte-identical to the reference's and decoded values bit-identical.

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no
CUDA device it raises unless the caller asks for ``device="cpu"``, where
the kernels' plain versions run.  Every argument of the reference's
entry points works.

Each device group runs under an ``engine.compress_group`` or
``engine.decode_group`` span (``repro_torch.obs``), the parent of the
executor's stage spans; ``group_cb`` receives one summary dict per group
(the service's occupancy and bucket metrics).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import bitstream
from ..core.lopc import CompressStats
from ..obs import span
from ..core.nonfinite import decode_nonfinite, encode_nonfinite
from ..core.quantize import abs_bound_from_mode, bin_dtype_for, check_bin_range, effective_eps
from ..tda.adaptive import ADAPTIVE_EB_MODES, ladder_indices
from . import buckets
from . import device as _device
from .executor import DECODE_PATHS, Executor, default_executor
from .plan import (
    HALO,
    CompressionPlan,
    TileLayout,
    canonical3d_shape,
    extract_halo_tiles,
    padded_with_border,
    scatter_interiors,
    tiles_for_region,
)

FLAG_ORDER_PRESERVING = bitstream.FLAG_ORDER_PRESERVING
FLAG_HAS_NONFINITE = bitstream.FLAG_HAS_NONFINITE
FLAG_ADAPTIVE_EB = bitstream.FLAG_ADAPTIVE_EB

DEFAULT_PLAN = CompressionPlan()


def resolve_device(device) -> torch.device:
    """The torch device to run on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev


def _check_decode_path(decode_path: str) -> None:
    if decode_path not in DECODE_PATHS:
        raise ValueError(f"unknown decode path {decode_path!r}")


# -------------------------------------------- nonfinite sidecar (ROI form)

def decode_nonfinite_region(payload: bytes, out_region: np.ndarray,
                            full_shape: tuple[int, ...],
                            region: tuple[slice, ...]) -> np.ndarray:
    """ROI variant: the sidecar indexes the full grid, so the mask and
    value streams are sliced down to the requested region."""
    r = bitstream.Reader(payload)
    packed = np.frombuffer(r.lp(), np.uint8)
    vals = np.frombuffer(r.lp(), out_region.dtype)
    n = int(np.prod(full_shape))
    mask = np.unpackbits(packed, count=n).astype(bool).reshape(full_shape)
    # value k of the sidecar belongs to the k-th masked cell in C order
    pos = np.cumsum(mask.reshape(-1)).reshape(full_shape) - 1
    m = mask[region]
    out_region = out_region.copy()
    out_region[m] = vals[pos[region][m]]
    return out_region


# ------------------------------------------------------------ validation

def _validate(x: np.ndarray, eb: float):
    if x.dtype not in (np.float32, np.float64):
        raise ValueError(f"LOPC compresses float32/float64 fields, got {x.dtype}")
    if x.ndim not in (1, 2, 3):
        raise ValueError(f"LOPC supports 1D/2D/3D grids, got ndim={x.ndim}")
    if eb <= 0:
        raise ValueError("error bound must be positive")


def _check_eps(x: np.ndarray, eps_abs: float):
    if eps_abs < float(np.finfo(x.dtype).tiny):
        raise ValueError(
            f"error bound {eps_abs:.3e} is below the smallest normal "
            f"{x.dtype} ({np.finfo(x.dtype).tiny:.3e}); sub-denormal bin "
            "widths cannot be honored")
    check_bin_range(x, eps_abs)


# -------------------------------------------------------------- compress

class _Request:
    """One field moving through a compress_many call."""

    def __init__(self, x, eb, mode, plan, adaptive_eb: str, dev):
        x = np.asarray(x)
        _validate(x, eb)
        self.nonfinite = None
        if not np.isfinite(x).all():
            x, self.nonfinite = encode_nonfinite(x)
        self.x = x
        self.eb = float(eb)
        self.mode = mode
        self.adaptive = adaptive_eb == "tda"
        self.eps_abs = abs_bound_from_mode(x, eb, mode)
        _check_eps(x, self.eps_abs)  # the tightest rung is the user bound
        self.layout = plan.layout_for(x.shape)
        self.ladder = None
        if self.adaptive:
            # scored on the device; the header bound is the loosest rung,
            # rung k_max the user bound (power-of-2 scaling is exact)
            self.ladder = ladder_indices(x, self.layout, self.eps_abs,
                                         device=dev)
            self.eps_abs = float(self.eps_abs * 2.0**bitstream.EB_LADDER_K_MAX)
        self.eps_eff = effective_eps(self.eps_abs)
        # bound on |bin| (round + <= 2 correction steps), known before any
        # device work: it picks the narrowest bins section width.  Adaptive
        # requests bound it at the tightest rung.
        eps_tight = self.eps_eff * (
            2.0**-bitstream.EB_LADDER_K_MAX if self.adaptive else 1.0)
        self.max_bin = float(np.max(np.abs(x), initial=0.0)) / eps_tight + 4
        self.bins_store = _store_bin_dtype(self.max_bin, np.dtype(x.dtype))
        self.sweeps = 0

    def eps_tiles(self) -> np.ndarray:
        """(n_tiles,) effective eps: the ladder-scaled per-tile bounds of
        an adaptive request, the uniform bound otherwise."""
        if not self.adaptive:
            return np.full(self.layout.n_tiles, self.eps_eff, np.float64)
        return self.eps_eff * np.exp2(-self.ladder.astype(np.float64))


def _store_bin_dtype(max_bin: float, dtype) -> np.dtype:
    """Narrowest section word width whose bins (and their deltas) fit."""
    native = np.dtype(bin_dtype_for(dtype))
    bound = 2 * max_bin + 4
    for cand in (np.dtype(np.int16), np.dtype(np.int32)):
        if cand.itemsize < native.itemsize and bound < np.iinfo(cand).max:
            return cand
    return native


def _serialize_tile_sections(streams, n_tiles: int, cpt: int):
    """Split a group's streams into per-tile RZE sections, trimming each
    tile's trailing all-zero chunks (decode restores them as zeros).
    ``streams`` is (bitmap rows, the rows' nonzero words front-packed in
    row-major order, per-row counts), so each tile's words are a
    prefix-sum slice of the run."""
    bitmap, packed, counts = streams
    chunk_len = bitmap.shape[1] * packed.dtype.itemsize * 8
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    out = []
    for j in range(n_tiles):
        nz = np.flatnonzero(counts[j * cpt : (j + 1) * cpt])
        keep = int(nz[-1]) + 1 if nz.size else 0
        out.append(bitstream.serialize_rze_section_flat(
            bitmap[j * cpt : j * cpt + keep],
            packed[offsets[j * cpt] : offsets[j * cpt + keep]],
            chunk_len))
    return out


def compress_many(fields, eb, mode: str = "noa", preserve_order: bool = True,
                  solver: str = "auto", plan: CompressionPlan | None = None,
                  return_stats: bool = False, put=None, group_cb=None,
                  encode_path: str = "auto", adaptive_eb: str = "off",
                  device="cuda"):
    """Compress a batch of scalar fields into v2 containers.

    ``fields`` may mix shapes, ranks and dtypes; ``eb`` is one bound or
    one per field.  Tiles of all requests sharing (dtype, tile shape,
    bins width) ride shared device batches.  ``preserve_order=False``
    writes plain containers (bins only: the bound holds, the local order
    is not kept).  ``solver`` accepts the reference's values; every
    schedule reaches the same least fixed point, and the tile-local
    solve always runs the blockwise kernel.  ``encode_path``
    (``staged``/``fused``/``auto``) picks the download form and, for
    plain f32 fields, the fused value encode; every path gives the same
    bytes (see ``executor``).  ``adaptive_eb="tda"`` scores every tile
    on the device and writes a per-tile eb ladder (``tda.adaptive``).
    ``group_cb``, when given, is called once per device group with a
    summary dict (``kind``/``dtype``/``tile``/``n_requests``/``n_tiles``
    and ``tile_batches``, the (real, capacity) device batches the group
    runs as): the hook the service reports occupancy through.
    ``put`` places every upload of a fresh executor: a callable
    ``np.ndarray -> torch.Tensor`` whose result must lie on ``device``
    (an executor raises otherwise), or ``distributed.make_tile_put``'s
    ``TilePut``, which also shards the device batches over its process
    group (every rank calls with the same arguments and gets the same
    blobs, equal to the unsharded ones).

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
    dev = resolve_device(device)
    plan = plan or DEFAULT_PLAN
    fields = list(fields)
    if not fields:
        return ([], []) if return_stats else []
    ebs = list(eb) if np.ndim(eb) else [eb] * len(fields)
    if len(ebs) != len(fields):
        raise ValueError("eb must be a scalar or one bound per field")
    reqs = [_Request(x, e, mode, plan, adaptive_eb, dev)
            for x, e in zip(fields, ebs)]
    ex = (Executor(plan, dev, encode_path, put) if put is not None
          else default_executor(plan, dev, encode_path))

    groups: dict[tuple, list[int]] = {}
    for i, r in enumerate(reqs):
        groups.setdefault(
            (np.dtype(r.x.dtype), r.layout.tile, r.bins_store, r.adaptive),
            []).append(i)

    blobs: list[bytes | None] = [None] * len(reqs)
    stats: list[CompressStats | None] = [None] * len(reqs)
    for (dtype, tile, _store, _adaptive), members in groups.items():
        sizes = [reqs[i].layout.n_tiles for i in members]
        if group_cb is not None:
            group_cb({
                "kind": "compress", "dtype": str(dtype), "tile": tile,
                "n_requests": len(members),
                "n_tiles": sum(sizes),
                "tile_batches": _compress_batches(sizes, plan),
            })
        with span("engine.compress_group", dtype=str(dtype), tile=list(tile),
                  n_requests=len(members), n_tiles=sum(sizes)):
            _compress_group([reqs[i] for i in members], dtype, ex,
                            preserve_order, [blobs, stats], members,
                            return_stats)
    if return_stats:
        return blobs, stats
    return blobs


def _compress_group(reqs, dtype, ex, preserve_order, out, members,
                    return_stats):
    """Build the NaN-marked haloed tile batch of one group, run the
    executor, serialize one v2 container per request."""
    blobs, stats = out
    nan = np.asarray(np.nan, dtype)
    x_tiles, eps_tiles, ranges = [], [], []
    n_total = 0
    for r in reqs:
        x_pb = padded_with_border(r.x.reshape(r.layout.canonical), r.layout, nan)
        x_tiles.append(extract_halo_tiles(x_pb, r.layout))
        eps_tiles.append(r.eps_tiles())
        ranges.append((n_total, n_total + r.layout.n_tiles))
        n_total += r.layout.n_tiles

    gs = ex.compress_tiles(
        np.concatenate(x_tiles), np.concatenate(eps_tiles),
        tuple(r.layout for r in reqs), dtype, preserve_order,
        bins_store=reqs[0].bins_store, adaptive=reqs[0].adaptive)

    # per-request solver diagnostics (sweeps are never serialized)
    if preserve_order:
        for r, (lo, hi) in zip(reqs, ranges):
            local = int(gs.local_sweeps[lo:hi].max(initial=0))
            rounds = int(gs.last_round[lo:hi].max(initial=0))
            r.sweeps = local + max(0, rounds - 1)

    bins_sections = _serialize_tile_sections(gs.bins, n_total, gs.bins_cpt)
    if preserve_order:
        sub_sections = _serialize_tile_sections(gs.subs, n_total, gs.subs_cpt)
    else:
        sub_sections = [b""] * n_total
    for r, (lo, hi), i in zip(reqs, ranges, members):
        flags = FLAG_ORDER_PRESERVING if preserve_order else 0
        extra = {}
        if r.nonfinite is not None:
            flags |= FLAG_HAS_NONFINITE
            extra[bitstream.TAG_NONFINITE] = r.nonfinite
        if r.adaptive:
            flags |= FLAG_ADAPTIVE_EB
            extra[bitstream.TAG_EB_LADDER] = \
                bitstream.serialize_eb_ladder(r.ladder)
        header = bitstream.Header(
            dtype=np.dtype(dtype), shape=r.x.shape, eb_mode=r.mode,
            eb=r.eb, eps_abs=float(r.eps_abs), flags=flags)
        tiles = list(zip(bins_sections[lo:hi], sub_sections[lo:hi]))
        blob = bitstream.write_container_v2(
            header, r.layout.tile, r.layout.grid, tiles, extra)
        blobs[i] = blob
        if return_stats:
            bin_bytes = sum(len(b) for b, _ in tiles)
            subbin_bytes = sum(len(s) for _, s in tiles)
            stats[i] = CompressStats(
                raw_bytes=r.x.nbytes, total_bytes=len(blob),
                bin_bytes=bin_bytes, subbin_bytes=subbin_bytes,
                header_bytes=len(blob) - bin_bytes - subbin_bytes,
                n_sweeps=r.sweeps, eps_abs=float(r.eps_abs))


def compress(field, eb, mode="noa", preserve_order=True, solver="auto",
             plan=None, return_stats=False, put=None, encode_path="auto",
             adaptive_eb="off", device="cuda"):
    """Single-field convenience wrapper over :func:`compress_many`."""
    out = compress_many([field], eb, mode, preserve_order, solver, plan,
                        return_stats, put, encode_path=encode_path,
                        adaptive_eb=adaptive_eb, device=device)
    if return_stats:
        blobs, stats = out
        return blobs[0], stats[0]
    return out[0]


# ------------------------------------------------------------ decompress

def container_layout(c) -> TileLayout:
    """TileLayout of a parsed v2 container, validating that the stored
    geometry is consistent with the field shape."""
    canonical = canonical3d_shape(c.header.shape)
    layout = TileLayout(tuple(c.header.shape), canonical,
                        tuple(int(t) for t in c.tile_shape),
                        tuple(int(g) for g in c.grid))
    expected = tuple(-(-cd // t) for cd, t in zip(canonical, layout.tile))
    if layout.grid != expected or layout.n_tiles != c.n_tiles:
        raise ValueError("corrupt LOPC container (grid/shape mismatch)")
    return layout


def _as_container(reader) -> bitstream.ContainerV2:
    """Accept a parsed v2 reader or raw blob bytes."""
    if isinstance(reader, (bytes, bytearray, memoryview)):
        return bitstream.read_container_v2(bytes(reader))
    return reader


def _compress_batches(sizes, plan):
    """Device batches a compress group will run as -> [(real, capacity)].

    The same ``buckets`` planning the executor uses, so ``group_cb``
    consumers (the service's pad-waste metrics) see exactly the batches
    that execute."""
    floor = max(buckets.CAPACITY_FLOOR, plan.batch_tiles)
    out = []
    for lo, hi in buckets.plan_request_chunks(tuple(sizes), floor):
        n = int(sum(sizes[lo:hi]))
        out.append((n, buckets.bucket_capacity(n, floor)))
    return out


def _decode_batches(n_tiles, plan):
    """Decode-side twin of :func:`_compress_batches`."""
    floor = max(buckets.CAPACITY_FLOOR, plan.batch_tiles)
    return [(n, buckets.bucket_capacity(n, floor))
            for n in buckets.plan_tile_chunks(n_tiles, floor)]


def _decode_runs(runs, plan, dev, group_cb=None):
    """Decode ``(container, layout, tile_ids)`` runs; tiles of every run
    with one (dtype, tile shape, order, section words) signature share
    device batches.  Returns one ``(len(tile_ids), *tile)`` array per
    run.  ``group_cb`` mirrors :func:`compress_many`'s hook."""
    groups: dict[tuple, list[int]] = {}
    for i, (c, layout, tile_ids) in enumerate(runs):
        if not tile_ids:
            continue
        order = bool(c.header.flags & FLAG_ORDER_PRESERVING)
        groups.setdefault((np.dtype(c.header.dtype), layout.tile, order,
                           c.stream_words()), []).append(i)
    outs = [np.empty((0,) + tuple(layout.tile), np.dtype(c.header.dtype))
            for c, layout, _ in runs]
    ex = default_executor(plan, dev)
    for (dtype, tile, order, words), members in groups.items():
        if group_cb is not None:
            n_tiles = sum(len(runs[i][2]) for i in members)
            group_cb({
                "kind": "decompress", "dtype": str(dtype), "tile": tile,
                "n_requests": len(members),
                "n_tiles": n_tiles,
                "tile_batches": _decode_batches(n_tiles, plan),
            })
        items, spans = [], []
        for i in members:
            c, layout, tile_ids = runs[i]
            eps_eff = effective_eps(c.header.eps_abs)
            # per-tile eb-ladder scaling (all-zero for uniform containers)
            ladder = c.eb_ladder()
            start = len(items)
            items.extend((c, t, eps_eff * 2.0 ** -int(ladder[t]))
                         for t in tile_ids)
            spans.append((i, start, len(items)))
        with span("engine.decode_group", dtype=str(dtype), tile=list(tile),
                  n_requests=len(members), n_tiles=len(items)):
            values = ex.decode_items(items, tile, dtype, order, words)
        for i, lo, hi in spans:
            outs[i] = values[lo:hi]
    return outs


def decode_tiles_for_region(reader, tile_ids,
                            plan: CompressionPlan | None = None,
                            decode_path: str = "auto",
                            device="cuda") -> np.ndarray:
    """Tile-granular decode -> values ``(len(tile_ids), *tile)``.

    ``reader`` is a parsed :class:`~repro_torch.core.bitstream.ContainerV2`
    or raw blob bytes.  Decodes exactly the requested tiles (the
    primitive under ``decompress_roi``); ``executor.DECODE_COUNTS``
    counts every tile that passes through.  ``decode_path`` takes the
    reference's values and is validated; every value decodes with the
    port's one decode kernel (kernel 3), which gives the reference's
    values on each of its paths.
    """
    _check_decode_path(decode_path)
    dev = resolve_device(device)
    c = _as_container(reader)
    return _decode_runs([(c, container_layout(c), list(tile_ids))],
                        plan or DEFAULT_PLAN, dev)[0]


def decode_tiles_many(runs, plan: CompressionPlan | None = None,
                      group_cb=None, decode_path: str = "auto",
                      device="cuda") -> list[np.ndarray]:
    """Batched :func:`decode_tiles_for_region`: ``runs`` is a list of
    ``(reader, tile_ids)`` pairs, and tiles of all runs sharing one
    (dtype, tile, order, words) signature share device batches.
    ``decode_path`` as in :func:`decode_tiles_for_region`; ``group_cb``
    as in :func:`compress_many` (``kind="decompress"``).
    """
    _check_decode_path(decode_path)
    dev = resolve_device(device)
    parsed = []
    for reader, tile_ids in runs:
        c = _as_container(reader)
        parsed.append((c, container_layout(c), list(tile_ids)))
    return _decode_runs(parsed, plan or DEFAULT_PLAN, dev, group_cb)


def assemble_interiors(values: np.ndarray, layout: TileLayout,
                       shape) -> np.ndarray:
    """Scatter decoded (n_tiles, *tile) interiors back into a field."""
    pb = np.zeros(tuple(d + 2 * HALO for d in layout.padded), values.dtype)
    scatter_interiors(values, layout, pb)
    padded = pb[HALO:-HALO, HALO:-HALO, HALO:-HALO]
    cn = layout.canonical
    return np.ascontiguousarray(padded[: cn[0], : cn[1], : cn[2]]).reshape(shape)


def _assemble_field(values, c, layout: TileLayout):
    out = assemble_interiors(values, layout, c.header.shape)
    if c.header.flags & FLAG_HAS_NONFINITE:
        out = decode_nonfinite(c.extra_section(bitstream.TAG_NONFINITE), out)
    return out


def decompress(blob: bytes, plan: CompressionPlan | None = None,
               decode_path: str = "auto", device="cuda") -> np.ndarray:
    """Reconstruct a full field from a v2 container.  ``decode_path`` as
    in :func:`decode_tiles_for_region`."""
    return decompress_many([blob], plan, decode_path=decode_path,
                           device=device)[0]


def decompress_many(blobs, plan: CompressionPlan | None = None,
                    group_cb=None, decode_path: str = "auto", device="cuda"):
    """Batched decode: tiles of all containers with one (tile shape,
    dtype, order, words) signature share device batches.
    ``decode_path`` as in :func:`decode_tiles_for_region`; ``group_cb``
    as in :func:`compress_many` (``kind="decompress"``)."""
    _check_decode_path(decode_path)
    dev = resolve_device(device)
    plan = plan or DEFAULT_PLAN
    parsed = []
    for b in blobs:
        c = bitstream.read_container_v2(b)
        layout = container_layout(c)
        parsed.append((c, layout, list(range(layout.n_tiles))))
    values = _decode_runs(parsed, plan, dev, group_cb)
    return [_assemble_field(v, c, layout)
            for v, (c, layout, _) in zip(values, parsed)]


def decompress_roi(blob: bytes, region: tuple[slice, ...],
                   plan: CompressionPlan | None = None,
                   decode_path: str = "auto", device="cuda") -> np.ndarray:
    """Partial decode: reconstruct only ``region`` of the field.

    ``region`` has one slice per *original* field dimension.  Slice
    semantics are numpy's: negative indices count from the end,
    out-of-range stops clamp to the field extent, steps must be 1, and
    the result equals ``decompress(blob)[region]`` exactly.  Zero-volume
    regions (empty or reversed slices) return an empty array without
    touching the device.  Non-finite cells in the region restore from
    the sidecar.  Decodes exactly the tiles that intersect the region.
    ``decode_path`` as in :func:`decode_tiles_for_region`.  A v3 chain
    of one frame reads frame 0; a longer chain raises ``ValueError``.
    """
    _check_decode_path(decode_path)
    if bitstream.container_version(blob) == bitstream.VERSION_CHAIN:
        return _roi_from_chain(blob, region, plan or DEFAULT_PLAN, device)
    c = bitstream.read_container_v2(blob)
    layout = container_layout(c)
    tile_ids = tiles_for_region(layout, region)
    values = decode_tiles_for_region(c, tile_ids, plan, decode_path, device)
    return region_from_tiles(c, layout, region, dict(zip(tile_ids, values)))


def _roi_from_chain(blob: bytes, region: tuple[slice, ...],
                    plan: CompressionPlan, device) -> np.ndarray:
    """ROI over a v3 chain: frame 0 of a one-frame chain (its sections
    are a v2 snapshot's); a longer chain is refused with the container
    version spelled out."""
    from ..temporal import decompress_frame  # lazy: temporal imports engine

    c = bitstream.read_container_v3(blob)
    if c.n_frames != 1:
        raise ValueError(
            f"decompress_roi expects a v2 snapshot container, got a "
            f"version {bitstream.VERSION_CHAIN} chain with {c.n_frames} "
            "frames; pick a frame with temporal.decompress_frame first")
    layout = container_layout(c)
    tiles_for_region(layout, region)  # validate slices before decoding
    full = decompress_frame(blob, 0, plan=plan, device=device)
    return np.ascontiguousarray(full[tuple(region)])


def region_from_tiles(c, layout: TileLayout, region: tuple[slice, ...],
                      tiles: dict[int, np.ndarray]) -> np.ndarray:
    """Assemble ``region`` of a field from decoded tile interiors.

    ``tiles`` maps tile id -> decoded ``(*tile,)`` values and must cover
    every tile intersecting the region.  Region semantics match
    :func:`decompress_roi`.
    """
    shape = c.header.shape
    tile_ids = tiles_for_region(layout, region)  # validates the region
    # empty/reversed slices clamp to zero extent (numpy slicing semantics)
    canon_region = (slice(0, 1),) * (3 - len(region)) + tuple(
        slice(sl.indices(n)[0], max(sl.indices(n)[0], sl.indices(n)[1]))
        for sl, n in zip(region, shape)
    )
    out_shape = tuple(sl.stop - sl.start for sl in canon_region)
    final_shape = out_shape[3 - len(region):]
    if not tile_ids or 0 in out_shape:
        return np.empty(final_shape, np.dtype(c.header.dtype))
    out = np.empty(out_shape, np.dtype(c.header.dtype))
    g1, g2 = layout.grid[1], layout.grid[2]
    t = layout.tile
    for tid in tile_ids:
        v = tiles[tid]
        gi, rem = divmod(tid, g1 * g2)
        gj, gk = divmod(rem, g2)
        src, dst = [], []
        for base, extent, sl in zip((gi * t[0], gj * t[1], gk * t[2]), t,
                                    canon_region):
            lo = max(base, sl.start)
            hi = min(base + extent, sl.stop)
            src.append(slice(lo - base, hi - base))
            dst.append(slice(lo - sl.start, hi - sl.start))
        out[tuple(dst)] = v[tuple(src)]
    out = out.reshape(final_shape)
    if c.header.flags & FLAG_HAS_NONFINITE:
        out = decode_nonfinite_region(
            c.extra_section(bitstream.TAG_NONFINITE), out, shape,
            tuple(slice(*sl.indices(n)[:2]) for sl, n in zip(region, shape)),
        )
    return out
