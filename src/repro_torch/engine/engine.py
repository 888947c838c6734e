"""Plan/execute compression engine (port of ``repro.engine.engine``).

``compress_many`` turns a mix of 1/2/3-D field requests into shared
fixed-shape tile batches (plan), runs them on the device (execute, see
``executor``), and serializes one v2 container per request.  Containers
are byte-identical to the reference's and decoded values bit-identical.

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no
CUDA device it raises unless the caller asks for ``device="cpu"``, where
the kernels' plain versions run.  Arguments outside this port's current
slice raise ``NotImplementedError`` naming the ROADMAP.md row that
brings them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import bitstream
from ..core.nonfinite import decode_nonfinite, encode_nonfinite
from ..core.quantize import abs_bound_from_mode, bin_dtype_for, check_bin_range, effective_eps
from . import device as _device
from .executor import default_executor
from .plan import (
    HALO,
    CompressionPlan,
    TileLayout,
    canonical3d_shape,
    extract_halo_tiles,
    padded_with_border,
    scatter_interiors,
)

FLAG_ORDER_PRESERVING = bitstream.FLAG_ORDER_PRESERVING
FLAG_HAS_NONFINITE = bitstream.FLAG_HAS_NONFINITE

DEFAULT_PLAN = CompressionPlan()


@dataclass
class CompressStats:
    raw_bytes: int
    total_bytes: int
    bin_bytes: int
    subbin_bytes: int
    header_bytes: int
    n_sweeps: int
    eps_abs: float

    @property
    def ratio(self) -> float:
        return self.raw_bytes / self.total_bytes


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


def _not_in_slice(what: str, row: int, name: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md module queue row {row} "
        f"({name}) brings it")


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

    def __init__(self, x, eb, mode, plan):
        x = np.asarray(x)
        _validate(x, eb)
        self.nonfinite = None
        if not np.isfinite(x).all():
            x, self.nonfinite = encode_nonfinite(x)
        self.x = x
        self.eb = float(eb)
        self.mode = mode
        self.eps_abs = abs_bound_from_mode(x, eb, mode)
        _check_eps(x, self.eps_abs)
        self.layout = plan.layout_for(x.shape)
        self.eps_eff = effective_eps(self.eps_abs)
        # bound on |bin| (round + <= 2 correction steps), known before any
        # device work: it picks the narrowest bins section width
        self.max_bin = float(np.max(np.abs(x), initial=0.0)) / self.eps_eff + 4
        self.bins_store = _store_bin_dtype(self.max_bin, np.dtype(x.dtype))
        self.sweeps = 0

    def eps_tiles(self) -> np.ndarray:
        return np.full(self.layout.n_tiles, self.eps_eff, np.float64)


def _store_bin_dtype(max_bin: float, dtype) -> np.dtype:
    """Narrowest section word width whose bins (and their deltas) fit."""
    native = np.dtype(bin_dtype_for(dtype))
    bound = 2 * max_bin + 4
    for cand in (np.dtype(np.int16), np.dtype(np.int32)):
        if cand.itemsize < native.itemsize and bound < np.iinfo(cand).max:
            return cand
    return native


def _serialize_tile_sections(streams, n_tiles: int, cpt: int):
    """Split batched raw chunk rows into per-tile RZE sections, trimming
    each tile's trailing all-zero chunks (decode restores them as
    zeros)."""
    bitmap, packed, counts = streams
    out = []
    for j in range(n_tiles):
        nz = np.flatnonzero(counts[j * cpt : (j + 1) * cpt])
        keep = int(nz[-1]) + 1 if nz.size else 0
        rows = slice(j * cpt, j * cpt + keep)
        out.append(bitstream.serialize_rze_section(
            bitmap[rows], packed[rows], counts[rows], compacted=False))
    return out


def compress_many(fields, eb, mode: str = "noa", preserve_order: bool = True,
                  solver: str = "auto", plan: CompressionPlan | None = None,
                  return_stats: bool = False, put=None, group_cb=None,
                  adaptive_eb: str = "off", device="cuda"):
    """Compress a batch of scalar fields into v2 containers.

    ``fields`` may mix shapes, ranks and dtypes; ``eb`` is one bound or
    one per field.  Tiles of all requests sharing (dtype, tile shape,
    bins width) ride shared device batches.  ``solver`` accepts the
    reference's values; every schedule reaches the same least fixed
    point, and the tile-local solve always runs the blockwise kernel.

    Returns a list of blobs, or (blobs, stats) when ``return_stats``.
    """
    if solver not in _device.SOLVERS:
        raise ValueError(f"unknown solver method {solver!r}")
    if adaptive_eb != "off":
        _not_in_slice("adaptive_eb", 9, "adaptive eb")
    if not preserve_order:
        _not_in_slice("preserve_order=False", 8, "the plain path")
    if put is not None:
        _not_in_slice("put", 13, "distributed")
    if group_cb is not None:
        _not_in_slice("group_cb", 12, "serving stack")
    dev = resolve_device(device)
    plan = plan or DEFAULT_PLAN
    fields = list(fields)
    if not fields:
        return ([], []) if return_stats else []
    ebs = list(eb) if np.ndim(eb) else [eb] * len(fields)
    if len(ebs) != len(fields):
        raise ValueError("eb must be a scalar or one bound per field")
    reqs = [_Request(x, e, mode, plan) for x, e in zip(fields, ebs)]
    ex = default_executor(plan, dev)

    groups: dict[tuple, list[int]] = {}
    for i, r in enumerate(reqs):
        groups.setdefault(
            (np.dtype(r.x.dtype), r.layout.tile, r.bins_store), []).append(i)

    blobs: list[bytes | None] = [None] * len(reqs)
    stats: list[CompressStats | None] = [None] * len(reqs)
    for (dtype, _tile, _store), members in groups.items():
        _compress_group([reqs[i] for i in members], dtype, ex,
                        [blobs, stats], members, return_stats)
    if return_stats:
        return blobs, stats
    return blobs


def _compress_group(reqs, dtype, ex, out, members, return_stats):
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
        tuple(r.layout for r in reqs), dtype, bins_store=reqs[0].bins_store)

    # per-request solver diagnostics (sweeps are never serialized)
    for r, (lo, hi) in zip(reqs, ranges):
        local = int(gs.local_sweeps[lo:hi].max(initial=0))
        rounds = int(gs.last_round[lo:hi].max(initial=0))
        r.sweeps = local + max(0, rounds - 1)

    bins_sections = _serialize_tile_sections(gs.bins, n_total, gs.bins_cpt)
    sub_sections = _serialize_tile_sections(gs.subs, n_total, gs.subs_cpt)
    for r, (lo, hi), i in zip(reqs, ranges, members):
        flags = FLAG_ORDER_PRESERVING
        extra = {}
        if r.nonfinite is not None:
            flags |= FLAG_HAS_NONFINITE
            extra[bitstream.TAG_NONFINITE] = r.nonfinite
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
             plan=None, return_stats=False, put=None, adaptive_eb="off",
             device="cuda"):
    """Single-field convenience wrapper over :func:`compress_many`."""
    out = compress_many([field], eb, mode, preserve_order, solver, plan,
                        return_stats, put, adaptive_eb=adaptive_eb,
                        device=device)
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


def _decode_runs(runs, plan, dev):
    """Decode ``(container, layout, tile_ids)`` runs; tiles of every run
    with one (dtype, tile shape, section words) signature share device
    batches.  Returns one ``(len(tile_ids), *tile)`` array per run."""
    groups: dict[tuple, list[int]] = {}
    for i, (c, layout, tile_ids) in enumerate(runs):
        if not tile_ids:
            continue
        if not c.header.flags & FLAG_ORDER_PRESERVING:
            _not_in_slice("decoding a preserve_order=False container", 8,
                          "the plain path")
        groups.setdefault((np.dtype(c.header.dtype), layout.tile,
                           c.stream_words()), []).append(i)
    outs = [np.empty((0,) + tuple(layout.tile), np.dtype(c.header.dtype))
            for c, layout, _ in runs]
    ex = default_executor(plan, dev)
    for (dtype, tile, words), members in groups.items():
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
        values = ex.decode_items(items, tile, dtype, words)
        for i, lo, hi in spans:
            outs[i] = values[lo:hi]
    return outs


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
               device="cuda") -> np.ndarray:
    """Reconstruct a full field from a v2 container."""
    return decompress_many([blob], plan, device=device)[0]


def decompress_many(blobs, plan: CompressionPlan | None = None,
                    device="cuda"):
    """Batched decode: tiles of all containers with one (tile shape,
    dtype, words) signature share device batches."""
    dev = resolve_device(device)
    plan = plan or DEFAULT_PLAN
    parsed = []
    for b in blobs:
        c = bitstream.read_container_v2(b)
        layout = container_layout(c)
        parsed.append((c, layout, list(range(layout.n_tiles))))
    values = _decode_runs(parsed, plan, dev)
    return [_assemble_field(v, c, layout)
            for v, (c, layout, _) in zip(values, parsed)]

