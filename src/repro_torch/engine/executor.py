"""Device-resident executor (port of ``repro.engine.executor``).

A compress group's tiles are uploaded once per device batch (padded to a
bucketed *resident capacity*), and the device stages run there:
quantize -> order flags -> bins encode -> halo-round subbin solve ->
subbin encode for order-preserving groups (adaptive groups: quantize at
per-tile eps, all-pairs flags, the halo-round solve in ordered space
seeded at the decode bases, the ordered distance as the subbin, in
16, 32 or 64 bits); quantize -> bins encode for
plain (``preserve_order=False``) groups, where an f32 group on the fused
path runs the whole chain as one kernel (``encode_values_fused``).  One
download per group brings back the streams, in one of two forms that
serialize to the same bytes: the *staged* form, (bitmap, words, counts)
chunk rows about the raw field's size, or the *compacted* form
(``device.compact_streams``: front-packed nonzero words and a
repeat-eliminated bitmap, about the payload's size).  ``encode_path``
picks the form: ``staged``, ``fused`` (always compacted), or ``auto``
(compacted on a CUDA device once a batch reaches
``FUSED_ENCODE_AUTO_MIN_ELEMS``).

Decode runs the other way: tile sections are deserialized into chunk
rows on the host, uploaded once per decode batch, decoded by one kernel
and downloaded as values.

``TRANSFER_COUNTS`` counts host<->device crossings by category
(``h2d_tiles``, ``h2d_aux``, ``d2h_aux``, ``d2h_round`` — the one
boolean read back per halo round —, ``d2h_sections``, ``h2d_sections``,
``d2h_values``) plus ``bytes_h2d`` / ``bytes_d2h``, and
``bytes_d2h_byte_level_saved``: the bytes the byte-level form of the
compacted runs saved against word-level compaction alone (the
reference's form); ``DECODE_COUNTS``
counts the ``tiles`` and the device ``batches`` every decode runs (the
probe that shows a region read touches only its tiles).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..codecs import rze
from ..codecs.transforms import NP_UNSIGNED
from ..core import bitstream
from ..core.quantize import bin_dtype_for
from . import buckets, device, halo
from .plan import CompressionPlan, TileLayout

TRANSFER_COUNTS: Counter = Counter()
DECODE_COUNTS: Counter = Counter()

_CHUNK_WORDS = {2: 8192, 4: 4096, 8: 2048}  # word bytes -> words / 16 KiB

CAPACITY_FLOOR = buckets.CAPACITY_FLOOR

ENCODE_PATHS = ("staged", "fused", "auto")

# The reference's decode backends.  The port accepts each of them and
# decodes every batch with its one decode kernel (kernel 3).
DECODE_PATHS = ("staged", "fused", "auto")

# encode_path="auto" takes the compacted download (and, for plain f32
# groups, the fused value encode) once a group's largest batch reaches
# this many padded elements, on a CUDA device only: the reference's own
# crossover, where the download shrink outweighs the compaction.
FUSED_ENCODE_AUTO_MIN_ELEMS = 1024 * 1024

# Compacted downloads fetch dense-buffer prefixes rounded up to this
# many words, so the padding tail stays well under a KiB per stream.
_DL_GRANULE_WORDS = 32

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


def use_fused_encode(encode_path: str, padded_elems: int,
                     on_cuda: bool) -> bool:
    """Does this compress group take the fused encode and the compacted
    download?  ``auto`` needs a CUDA device and a batch of at least
    ``FUSED_ENCODE_AUTO_MIN_ELEMS`` padded elements; ``fused`` always
    does, on the CPU too."""
    if encode_path == "staged":
        return False
    if encode_path == "fused":
        return True
    return on_cuda and padded_elems >= FUSED_ENCODE_AUTO_MIN_ELEMS


def reset_transfer_counts() -> None:
    TRANSFER_COUNTS.clear()


def reset_decode_counts() -> None:
    DECODE_COUNTS.clear()


def resident_capacity(n_tiles: int, floor: int = CAPACITY_FLOOR) -> int:
    """Resident-batch capacity class for a group of ``n_tiles`` tiles."""
    return buckets.bucket_capacity(n_tiles, floor)


def chunks_per_tile(layout: TileLayout, bdt) -> tuple[int, int]:
    """-> (chunks per tile, chunk length in words)."""
    chunk_len = _CHUNK_WORDS[np.dtype(bdt).itemsize]
    return -(-layout.tile_elems // chunk_len), chunk_len


def _download(t: torch.Tensor) -> np.ndarray:
    """One device -> host copy; 2-D word rows come back unsigned."""
    a = t.cpu().numpy()
    return a.view(NP_UNSIGNED[a.dtype.itemsize]) if a.ndim == 2 else a


@dataclass
class GroupStreams:
    """One compress group's encoded streams + solver diagnostics (host
    arrays).  A stream is (bitmap rows, the rows' nonzero words as one
    row-major run, per-row counts), whichever the download form."""

    bins: tuple[np.ndarray, np.ndarray, np.ndarray]
    subs: tuple[np.ndarray, np.ndarray, np.ndarray] | None
    local_sweeps: np.ndarray                          # (n_tiles,) int32
    last_round: np.ndarray                            # (n_tiles,) int32
    bins_cpt: int
    subs_cpt: int
    # with ``keep_bins``: each request's (n_tiles, *tile) bins, on the device
    bins_resident: list[torch.Tensor] | None = None


class Executor:
    """Execute half of the engine for one plan on one device.

    ``encode_path`` (``staged``/``fused``/``auto``) picks the compress
    download form (see the module docstring); every path gives the same
    bytes.
    """

    def __init__(self, plan: CompressionPlan, device: torch.device,
                 encode_path: str = "auto"):
        if encode_path not in ENCODE_PATHS:
            raise ValueError(f"unknown encode path {encode_path!r}")
        self.plan = plan
        self.device = torch.device(device)
        self.encode_path = encode_path

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------ compress

    def compress_tiles(self, x_tiles: np.ndarray, eps_tiles: np.ndarray,
                       layouts: tuple[TileLayout, ...], dtype,
                       preserve_order: bool = True,
                       bins_store=None, adaptive: bool = False,
                       prev_bins=None, keep_bins: bool = False) -> GroupStreams:
        """Run one compress group on the device.

        ``x_tiles`` is the group's concatenated haloed tiles with NaN
        marking every cell outside a field; ``eps_tiles`` the per-tile
        effective bounds; ``bins_store`` the (possibly narrowed) section
        word dtype of the bins stream.  ``adaptive`` groups (per-tile eb
        ladders) solve in ordered space: all-pairs flags, the state seeded
        at each cell's decode base, the subbin the ordered distance
        climbed (``device.resident_frontend_adaptive``).  Plain groups
        upload no halo tables and run no flags and no solve.

        A frame chain's step (``repro_torch.temporal``) passes
        ``keep_bins``, which keeps every request's bins on the device
        (``GroupStreams.bins_resident``), and, for a residual frame,
        ``prev_bins``: each request's bins of the frame before, on the
        device.  The bins stream then holds the residual against them,
        zigzag-encoded, and the quantize stays a stage of its own (no
        fused value encode).
        """
        layout0 = layouts[0]
        n_total = x_tiles.shape[0]
        tdt = _TORCH_DTYPE[np.dtype(dtype)]
        floor = max(CAPACITY_FLOOR, self.plan.batch_tiles)
        bins_store = np.dtype(bins_store or bin_dtype_for(dtype))
        bins_tdt = _TORCH_DTYPE[bins_store]
        bins_cpt, bins_chunk = chunks_per_tile(layout0, bins_store)
        sizes = tuple(lay.n_tiles for lay in layouts)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        spans = buckets.plan_request_chunks(sizes, floor)
        # one pick per group (its largest batch decides), so the whole
        # group's streams share one form through serialization
        max_capacity = max(
            resident_capacity(int(offsets[hi] - offsets[lo]), floor)
            for lo, hi in spans)
        fused = use_fused_encode(self.encode_path,
                                 max_capacity * layout0.tile_elems,
                                 self.device.type == "cuda")
        values_fused = (fused and not preserve_order and not keep_bins
                        and tdt == torch.float32)
        chunks = []
        resident = []
        for lo, hi in spans:
            r0, r1 = int(offsets[lo]), int(offsets[hi])
            n_chunk = r1 - r0
            capacity = resident_capacity(n_chunk, floor)
            xc, ec = x_tiles[r0:r1], eps_tiles[r0:r1]
            pad = capacity - n_chunk
            if pad:
                xc = np.concatenate([
                    xc, np.full((pad,) + xc.shape[1:], np.nan, xc.dtype)])
                ec = np.concatenate([ec, np.ones(pad, np.float64)])
            TRANSFER_COUNTS["h2d_tiles"] += 1
            TRANSFER_COUNTS["h2d_aux"] += 1
            TRANSFER_COUNTS["bytes_h2d"] += xc.nbytes + ec.nbytes
            x_dev, eps_dev = self._put(xc), self._put(ec)
            if values_fused:
                chunks.append([n_chunk, capacity, device.resident_encode_fused(
                    x_dev, eps_dev, tdt, bins_tdt, bins_chunk), None])
                continue
            if adaptive:
                bins_enc, s_init, flags = device.resident_frontend_adaptive(
                    x_dev, eps_dev, tdt)
            else:
                bins_enc, bins_m, vals_m = device.resident_quantize(
                    x_dev, eps_dev, tdt, preserve_order)
            del x_dev
            stream, transform = bins_enc, "delta"
            if prev_bins is not None:
                prev = list(prev_bins[lo:hi])
                if pad:
                    prev.append(bins_enc.new_zeros((pad,) + layout0.tile))
                stream = device.residual_tiles(bins_enc, torch.cat(prev))
                transform = "zigzag"
            # a narrower store wraps, as the reference's astype does
            bins_s = device.encode_tiles(
                stream.to(bins_tdt).reshape(capacity, -1), bins_chunk,
                transform)
            if keep_bins:
                resident.extend(torch.split(bins_enc[:n_chunk], sizes[lo:hi]))
            del bins_enc, stream
            if not preserve_order:
                chunks.append([n_chunk, capacity, bins_s, None])
                continue
            idx, mask = halo.group_index(layouts[lo:hi], capacity)
            adj = halo.group_adjacency(layouts[lo:hi])
            TRANSFER_COUNTS["h2d_aux"] += 4
            TRANSFER_COUNTS["bytes_h2d"] += (idx.nbytes + mask.nbytes
                                             + adj[0].nbytes + adj[1].nbytes)
            adj = tuple(self._put(a) for a in adj)
            if adaptive:
                s_final, local1, last_round, rounds = device.resident_solve(
                    flags, self._put(idx), self._put(mask),
                    max_rounds=n_chunk * layout0.tile_elems + 2,
                    adjacency=adj, sub0=s_init, n_real=n_chunk)
                # the stored subbin is the ordered distance climbed above
                # the bin base (0 at invalid cells, whose state never
                # moves); subtracting in the state's own width wraps as
                # the reference's unsigned subtraction does: no widening
                sub = s_final - s_init
                del s_final, s_init
            else:
                flags = device.resident_flags(bins_m, vals_m, capacity)
                del bins_m, vals_m
                sub, local1, last_round, rounds = device.resident_solve(
                    flags, self._put(idx), self._put(mask),
                    max_rounds=n_chunk * layout0.tile_elems + 2,
                    adjacency=adj, n_real=n_chunk)
            TRANSFER_COUNTS["d2h_round"] += rounds
            chunks.append([n_chunk, capacity, bins_s, sub, local1,
                           last_round])

        subs_cpt = 0
        if preserve_order:
            # the width is picked from the *group* maximum so chunking
            # never changes the subbin stream
            TRANSFER_COUNTS["d2h_aux"] += len(chunks)
            sub_top = max(device.sub_max(c[3]) for c in chunks)
            if sub_top < 2**15:
                sub_store = np.dtype(np.int16)
            elif sub_top < 2**31:
                sub_store = np.dtype(np.int32)
            else:
                # adaptive ordered-space distances of f64 fields can
                # exceed int32: kernel 2's w=64 instantiation encodes them
                sub_store = np.dtype(np.int64)
            subs_cpt, subs_chunk = chunks_per_tile(layout0, sub_store)
            for c in chunks:
                c[3] = device.encode_tiles(
                    c[3].to(_TORCH_DTYPE[sub_store]).reshape(c[1], -1),
                    subs_chunk, "raw")

        # only real-tile rows travel: pad tiles' rows never serialize
        ns = [c[0] for c in chunks]
        streams = [None if s is None else tuple(a[: c[0] * cpt] for a in s)
                   for c in chunks for s, cpt in zip(c[2:4], (bins_cpt, subs_cpt))]
        extras = [c[4:6] for c in chunks] if preserve_order else []
        if fused:
            host, extras = fetch_compacted_streams(streams, extras)
        else:
            TRANSFER_COUNTS["d2h_sections"] += 1
            host = [None if s is None else [_download(a) for a in s]
                    for s in streams]
            extras = [[_download(a) for a in e] for e in extras]
            TRANSFER_COUNTS["bytes_d2h"] += sum(
                a.nbytes for group in (*host, *extras) if group is not None
                for a in group)
            # the rows' nonzero words, row-major: the compacted form
            host = [None if h is None else (h[0], h[1][h[1] != 0], h[2])
                    for h in host]
        bins_s = _cat_streams(host[0::2])
        subs_s = _cat_streams(host[1::2]) if preserve_order else None
        if preserve_order:
            local1 = np.concatenate([e[0][:n] for e, n in zip(extras, ns)])
            last_round = np.concatenate([e[1][:n] for e, n in zip(extras, ns)])
        else:
            local1 = last_round = np.zeros(n_total, np.int32)
        return GroupStreams(bins_s, subs_s, local1, last_round, bins_cpt,
                            subs_cpt, resident if keep_bins else None)

# ------------------------------------------------------------- decode

    def decode_items(self, items, tile: tuple[int, int, int], dtype,
                     order: bool, words: tuple[int, int]) -> np.ndarray:
        """Decode a tile work-list -> values (n, *tile).

        ``items`` is a list of (container, tile_id, eps_eff) sharing one
        (tile shape, dtype, order, section words) signature, so tiles of
        different containers ride the same device batches; ``words`` is
        the (bins, subs) section word width in bytes (subs 0 for plain
        containers).  Each batch is one stream upload, one kernel launch
        and one value download.
        """
        dtype = np.dtype(dtype)
        tile_elems = int(np.prod(tile))
        if order and words[1] not in _CHUNK_WORDS:
            # header flags promise a subbin stream the sections lack
            raise ValueError("corrupt LOPC container (missing subbin stream)")
        n = len(items)
        if not n:
            return np.zeros((0,) + tuple(tile), dtype)
        DECODE_COUNTS["tiles"] += n
        floor = max(CAPACITY_FLOOR, self.plan.batch_tiles)
        parts = []
        pos = 0
        for n_chunk in buckets.plan_tile_chunks(n, floor):
            batch = resident_capacity(n_chunk, floor)
            parts.append(self._decode_chunk(
                items[pos : pos + n_chunk], tile_elems, dtype, order, words,
                batch))
            pos += n_chunk
        out = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return out.reshape((n,) + tuple(tile))

    def stage_rows(self, items, tile_elems: int, order: bool, words,
                   batch: int):
        """Deserialize a decode batch's tile sections into the kernel's
        operands, on the device: (bitmap, packed[, sub_bitmap,
        sub_packed]) word rows in signed twins and the (batch,) f64 eps;
        the subbin rows only for an order-preserving batch."""
        def alloc(word):
            chunk_len = _CHUNK_WORDS[word]
            cpt = -(-tile_elems // chunk_len)
            udt = NP_UNSIGNED[word]
            bitmap = np.zeros((batch * cpt, chunk_len // (word * 8)), udt)
            packed = np.zeros((batch * cpt, chunk_len), udt)
            return bitmap, packed, cpt

        streams = [alloc(words[0])] + ([alloc(words[1])] if order else [])
        eps = np.ones(batch, np.float64)
        for j, (c, t, eps_eff) in enumerate(items):
            eps[j] = eps_eff
            for (bitmap, packed, cpt), section in zip(streams,
                                                      c.tile_payloads(t)):
                _fill_rows(bitmap, packed, section, j * cpt, cpt)
        arrays = [a.view(f"<i{a.dtype.itemsize}")
                  for bitmap, packed, _ in streams for a in (bitmap, packed)]
        arrays.append(eps)
        TRANSFER_COUNTS["h2d_sections"] += 1
        TRANSFER_COUNTS["bytes_h2d"] += sum(a.nbytes for a in arrays)
        return [self._put(a) for a in arrays]

    def _decode_chunk(self, items, tile_elems: int, dtype, order: bool,
                      words, batch: int):
        DECODE_COUNTS["batches"] += 1
        operands = self.stage_rows(items, tile_elems, order, words, batch)
        decode = (device.resident_decode_order if order
                  else device.resident_decode_plain)
        out = decode(*operands, tile_elems, _TORCH_DTYPE[dtype])
        TRANSFER_COUNTS["d2h_values"] += 1
        out_h = out.cpu().numpy()
        TRANSFER_COUNTS["bytes_d2h"] += out_h.nbytes
        return out_h[: len(items)]


def _fill_rows(bitmap: np.ndarray, packed: np.ndarray, section: bytes,
               row0: int, cpt: int) -> None:
    """Deserialize one tile section into its chunk-row span.

    Sections may carry *fewer* than ``cpt`` chunks: the serializer trims
    trailing all-zero chunks, and missing rows decode as zero words.
    """
    bm, pk = bitstream.deserialize_rze_section(section)
    if bm.shape[0] > cpt:
        raise ValueError("corrupt LOPC container (tile section too long)")
    if bm.shape[0] and (bm.dtype != bitmap.dtype or pk.shape[1] != packed.shape[1]):
        raise ValueError("corrupt LOPC container (section word size)")
    bitmap[row0 : row0 + bm.shape[0]] = bm
    packed[row0 : row0 + pk.shape[0]] = pk


def _cat_streams(parts):
    """Concatenate the device batches' host streams (real-tile rows
    only), in either download form."""
    if len(parts) == 1:
        return tuple(parts[0])
    return tuple(np.concatenate(cols) for cols in zip(*parts))


def _granule_len(total: int, size: int) -> int:
    """Granule-rounded dense-prefix length (capped at the buffer)."""
    return min(size, -(-total // _DL_GRANULE_WORDS) * _DL_GRANULE_WORDS)


def _pick_run(run, n_words: int, n_nzbytes: int):
    """The smaller download of one compacted run -> (tensors to fetch,
    form): its first ``n_words`` words, or its nonzero-byte mask and
    nonzero bytes."""
    dense, mask, nz = run
    n_bytes = n_words * dense.element_size()
    word_form = _granule_len(n_words, dense.numel()) * dense.element_size()
    mask_len = _granule_len(-(-n_bytes // 8), mask.numel())
    byte_form = mask_len + _granule_len(n_nzbytes, nz.numel())
    if word_form <= byte_form:
        return [dense[: _granule_len(n_words, dense.numel())]], "words"
    TRANSFER_COUNTS["bytes_d2h_byte_level_saved"] += word_form - byte_form
    return [mask[:mask_len], nz[: _granule_len(n_nzbytes, nz.numel())]], "bytes"


def _restore_run(parts, form: str, n_words: int, n_nzbytes: int, udt):
    """Host inverse of :func:`_pick_run` -> the run's words (unsigned)."""
    if form == "words":
        return parts[0][:n_words].view(udt)
    nbytes = n_words * np.dtype(udt).itemsize
    raw = rze.np_unrze_bytes(parts[0], parts[1][:n_nzbytes], nbytes)
    return raw.view(udt)


def fetch_compacted_streams(streams, extras=()):
    """Download device (bitmap, words, counts) streams at about payload
    size.

    Each non-``None`` stream is compacted on the device
    (``device.compact_streams``), the per-stream totals come back as one
    small ``d2h_aux`` fetch (the only host sync), and one
    ``d2h_sections`` crossing drains the keepmaps, the smaller form of
    each compacted run (granule-rounded prefixes) and ``extras``
    (tensors such as the solver diagnostics).  Streams are restored on
    the host to the flat form the serializer takes: (bitmap rows,
    front-packed nonzero words, counts), the counts being the bitmap
    rows' popcounts.  ``None`` entries pass through (the plain path's
    empty subbin slots).  Returns (restored, host extras).
    """
    live = [(i, device.compact_streams(s[0], s[1]))
            for i, s in enumerate(streams) if s is not None]
    TRANSFER_COUNTS["d2h_aux"] += 1
    totals = torch.stack([c[3] for _, c in live]).cpu().numpy()
    TRANSFER_COUNTS["bytes_d2h"] += totals.nbytes
    fetch, forms = [], []
    for (_, (keepmap, kept, words, _)), tot in zip(live, totals):
        n_words, n_kept, nz_words, nz_kept = (int(t) for t in tot)
        kept_parts, kept_form = _pick_run(kept, n_kept, nz_kept)
        word_parts, word_form = _pick_run(words, n_words, nz_words)
        fetch.append(([keepmap], kept_parts, word_parts))
        forms.append((kept_form, word_form))
    TRANSFER_COUNTS["d2h_sections"] += 1
    fetch_h = [[[t.cpu().numpy() for t in part] for part in f] for f in fetch]
    extras_h = [[t.cpu().numpy() for t in e] for e in extras]
    TRANSFER_COUNTS["bytes_d2h"] += sum(
        a.nbytes for f in fetch_h for part in f for a in part) + sum(
        a.nbytes for e in extras_h for a in e)
    restored = [None] * len(streams)
    for (i, _), tot, (keepmap, kept, words), (kept_form, word_form) in zip(
            live, totals, fetch_h, forms):
        n_words, n_kept, nz_words, nz_kept = (int(t) for t in tot)
        bitmap = streams[i][0]
        udt = np.dtype(NP_UNSIGNED[bitmap.element_size()])
        restored[i] = _restore_stream(
            keepmap[0], _restore_run(kept, kept_form, n_kept, nz_kept, udt),
            _restore_run(words, word_form, n_words, nz_words, udt),
            tuple(bitmap.shape), udt)
    return restored, extras_h


def _restore_stream(keepmap, kept, words, bitmap_shape, bitmap_dtype):
    """Undo the repeat elimination of one stream's bitmap and recompute
    its per-row counts (the rows' popcounts) -> (bitmap, words, counts)."""
    rows, bwords = bitmap_shape
    bitmap = rze.np_repeat_restore(
        keepmap, kept, rows * bwords, bitmap_dtype).reshape(rows, bwords)
    word = bitmap_dtype.itemsize
    bits = np.unpackbits(
        bitmap.astype(f">u{word}").view(np.uint8).reshape(rows, -1), axis=1)
    counts = bits.sum(axis=1).astype(np.int32)
    return bitmap, words, counts


@lru_cache(maxsize=64)
def default_executor(plan: CompressionPlan, device: torch.device,
                     encode_path: str = "auto") -> Executor:
    """Shared executors, one per (plan, device, encode path)."""
    return Executor(plan, device, encode_path)
