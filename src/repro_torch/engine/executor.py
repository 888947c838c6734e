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

Stage spans (``repro_torch.obs``), under the reference's names: a
compress group opens ``exec.upload`` (tiles, eps and the halo tables of
one device batch) and ``exec.solve`` (the frontend, the bins encode and
the halo-round solve of that batch; on the fused plain f32 path the
value encode) per batch, then ``exec.encode`` (the subbin encode) and
``exec.download``, inside which the compacted form opens
``exec.compaction``.  The reference's compaction span holds the word-level
compaction and its totals fetch; the port's wraps its counterpart, the
word- and byte-level compaction (``device.compact_streams``) and the one
totals fetch.  A decode batch opens ``exec.stream_prep`` (the host's
section parse), ``exec.decode`` (the upload and the kernel) and
``exec.download``.  The port adds three host stages the reference does
not have: ``exec.pad`` (a batch's pad rows joined to its tiles and
eps), ``exec.restore`` (inside ``exec.download``: the host's restore of
the downloaded streams to the serializer's form) and ``exec.concat``
(the join of a decode's batches).  Every stage opens through
``obs.stage`` on the executor's device: on a CUDA device it records a
timing event on the current stream at each edge, which becomes the
span's ``device_us`` tag when the spans are read, so no stage
synchronizes for tracing; disabled, the spans are one shared no-op.  A
frame chain's step opens none, as in the reference.

``TRANSFER_COUNTS`` counts host<->device crossings by category
(``h2d_tiles``, ``h2d_aux``, ``d2h_aux``, ``d2h_round`` — the one
boolean read back per halo round —, ``d2h_sections``, ``h2d_sections``,
``d2h_values``) plus ``bytes_h2d`` / ``bytes_d2h``, ``bytes_h2d_pad``
(the part of ``bytes_h2d`` that is pad rows of a compress batch: its
tiles, eps, halo index and mask rows past the batch's real tiles), and
``bytes_d2h_byte_level_saved``: the bytes the byte-level form of the
compacted runs saved against word-level compaction alone (the
reference's form); ``DECODE_COUNTS``
counts the ``tiles`` and the device ``batches`` every decode runs (the
probe that shows a region read touches only its tiles).  Both are
``obs.CounterView``s over the process registry's families
``lopc_transfers_total`` and ``lopc_decodes_total``: writers use the
locked ``.add``, so concurrent services lose no update, and readers keep
the ``Counter`` idioms (``[]``, ``dict()``, ``.clear()``).

``put`` (``engine.compress_many``'s hook) places every upload of an
executor built for it: a plain callable only places (its tensor must
lie on the executor's device), while ``distributed.TilePut`` also
shards: a resident batch whose capacity divides by its group's size
runs as contiguous rank blocks (``_shard``; the block's tiles, eps and
halo-table rows uploaded, the frontend and encodes run on the block,
the streams' raw-size rows all-gathered before the download, the
subbin width the group's maximum, ``device.resident_solve`` on a
replicated state), and every rank downloads and serializes the same
bytes.

One ``Executor`` per (plan, device, encode path) is cached by
``default_executor`` and shared by every service worker that runs that
configuration.  Sharing is safe: an executor holds only its immutable
configuration, every call builds its own tensors, the counters are
locked, and ``halo.group_adjacency``'s cache is an ``lru_cache``
(thread-safe).  Two workers' calls may interleave on the device's
current stream; each call's results depend only on its own tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..codecs import rze
from ..codecs.transforms import NP_UNSIGNED
from ..core import bitstream
from ..core.quantize import bin_dtype_for
from ..obs import REGISTRY, CounterView
from ..obs import stage as device_stage
from ..obs.trace import NOOP_SPAN
from . import buckets, device, halo
from .plan import CompressionPlan, TileLayout

TRANSFER_COUNTS: CounterView = CounterView(REGISTRY.counter(
    "lopc_transfers_total", "host-device crossings by category"))
DECODE_COUNTS: CounterView = CounterView(REGISTRY.counter(
    "lopc_decodes_total", "tile sections decoded and their device batches"))

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


def _no_span(name: str, **tags):
    """The stage span of a caller that opens none (a chain step)."""
    return NOOP_SPAN


def reset_transfer_counts() -> None:
    TRANSFER_COUNTS.clear()


def reset_decode_counts() -> None:
    DECODE_COUNTS.clear()


def decode_count(key: str = "tiles") -> int:
    return DECODE_COUNTS[key]


def transfer_count(*keys: str) -> int:
    """The crossings counted under ``keys`` (all of them when none is
    given)."""
    return sum(TRANSFER_COUNTS[k] for k in keys) if keys else sum(
        TRANSFER_COUNTS.values())


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
                 encode_path: str = "auto", put=None):
        if encode_path not in ENCODE_PATHS:
            raise ValueError(f"unknown encode path {encode_path!r}")
        self.plan = plan
        self.device = torch.device(device)
        self.encode_path = encode_path
        self.put = put

    def _put(self, a: np.ndarray) -> torch.Tensor:
        if self.put is None:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        t = self.put(a)
        if not (isinstance(t, torch.Tensor)
                and _device_key(t.device) == _device_key(self.device)):
            where = t.device if isinstance(t, torch.Tensor) else type(t)
            raise ValueError(f"put placed an upload on {where}; the executor "
                             f"runs on {self.device}")
        return t

    def _stage(self, name: str, **tags):
        """A stage span on this executor's device (``obs.stage``)."""
        return device_stage(name, self.device, **tags)

    def _shard(self, capacity: int):
        """This rank's block of a batch of ``capacity`` tiles when ``put``
        shards batches (``distributed.TilePut``), else ``None``: the batch
        runs whole."""
        block = getattr(self.put, "block", None)
        return None if block is None else block(capacity)

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
        # a chain step (the only caller that keeps its bins) opens no
        # stage spans, as in the reference
        stage = _no_span if keep_bins else self._stage
        layout0 = layouts[0]
        n_total = x_tiles.shape[0]
        tdt = _TORCH_DTYPE[np.dtype(dtype)]
        floor = max(CAPACITY_FLOOR, self.plan.batch_tiles)
        bins_store = np.dtype(bins_store or bin_dtype_for(dtype))
        bins_tdt = _TORCH_DTYPE[bins_store]
        bins_cpt, bins_chunk = chunks_per_tile(layout0, bins_store)
        sizes = tuple(lay.n_tiles for lay in layouts)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        batches = buckets.plan_request_chunks(sizes, floor)
        # one pick per group (its largest batch decides), so the whole
        # group's streams share one form through serialization
        max_capacity = max(
            resident_capacity(int(offsets[hi] - offsets[lo]), floor)
            for lo, hi in batches)
        fused = use_fused_encode(self.encode_path,
                                 max_capacity * layout0.tile_elems,
                                 self.device.type == "cuda")
        values_fused = (fused and not preserve_order and not keep_bins
                        and tdt == torch.float32)
        chunks = []
        resident = []
        shards = []
        for lo, hi in batches:
            r0, r1 = int(offsets[lo]), int(offsets[hi])
            n_chunk = r1 - r0
            capacity = resident_capacity(n_chunk, floor)
            xc, ec = x_tiles[r0:r1], eps_tiles[r0:r1]
            pad = capacity - n_chunk
            if pad:
                with stage("exec.pad", tiles=n_chunk, rows=pad):
                    xc = np.concatenate([
                        xc, np.full((pad,) + xc.shape[1:], np.nan, xc.dtype)])
                    ec = np.concatenate([ec, np.ones(pad, np.float64)])
            # a sharded batch uploads only this rank's block of rows
            shard = self._shard(capacity)
            b0, b1 = (0, capacity) if shard is None else (shard.lo, shard.hi)
            xc, ec = xc[b0:b1], ec[b0:b1]
            # the uploaded rows past the batch's real tiles
            pad_up = max(0, b1 - max(b0, n_chunk))
            TRANSFER_COUNTS.add("h2d_tiles")
            TRANSFER_COUNTS.add("h2d_aux")
            TRANSFER_COUNTS.add("bytes_h2d", xc.nbytes + ec.nbytes)
            TRANSFER_COUNTS.add("bytes_h2d_pad",
                                pad_up * (xc[:1].nbytes + ec[:1].nbytes))
            with stage("exec.upload", tiles=n_chunk, capacity=capacity,
                       nbytes=xc.nbytes):
                x_dev, eps_dev = self._put(xc), self._put(ec)
                tables = ()
                if preserve_order:
                    idx, mask = halo.group_index(layouts[lo:hi], capacity)
                    idx, mask = idx[b0:b1], mask[b0:b1]
                    adj = halo.group_adjacency(layouts[lo:hi])
                    TRANSFER_COUNTS.add("h2d_aux", 4)
                    TRANSFER_COUNTS.add("bytes_h2d", idx.nbytes + mask.nbytes
                                        + adj[0].nbytes + adj[1].nbytes)
                    TRANSFER_COUNTS.add("bytes_h2d_pad", pad_up * (
                        idx[:1].nbytes + mask[:1].nbytes))
                    tables = (self._put(idx), self._put(mask),
                              tuple(self._put(a) for a in adj))
            with stage("exec.solve", tiles=n_chunk, capacity=capacity,
                       solver="blockwise", adaptive=adaptive):
                chunk = self._solve_chunk(
                    x_dev, eps_dev, tables, n_chunk, capacity, tdt, bins_tdt,
                    bins_chunk, preserve_order, adaptive, values_fused,
                    None if prev_bins is None else prev_bins[lo:hi],
                    resident if keep_bins else None, sizes[lo:hi],
                    layout0, shard)
                del x_dev, eps_dev, tables
            buckets.record_batch("compress", n_chunk, capacity)
            chunks.append(chunk)
            shards.append(shard)

        subs_cpt = 0
        if preserve_order:
            # the width is picked from the *group* maximum so chunking
            # never changes the subbin stream; a sharded group's ranks each
            # hold blocks, so the maximum is the group's over all ranks
            TRANSFER_COUNTS.add("d2h_aux", len(chunks))
            sub_top = max(device.sub_max(c[3]) for c in chunks)
            sharded = next((sh for sh in shards if sh is not None), None)
            if sharded is not None:
                sub_top = sharded.all_reduce_max(sub_top)
            if sub_top < 2**15:
                sub_store = np.dtype(np.int16)
            elif sub_top < 2**31:
                sub_store = np.dtype(np.int32)
            else:
                # adaptive ordered-space distances of f64 fields can
                # exceed int32: kernel 2's w=64 instantiation encodes them
                sub_store = np.dtype(np.int64)
            subs_cpt, subs_chunk = chunks_per_tile(layout0, sub_store)
            with stage("exec.encode", chunks=len(chunks), fused=fused,
                       sub_word=sub_store.itemsize):
                for c, shard in zip(chunks, shards):
                    c[3] = _gathered(shard, device.encode_tiles(
                        c[3].to(_TORCH_DTYPE[sub_store]).reshape(
                            c[3].shape[0], -1),
                        subs_chunk, "raw"))

        # only real-tile rows travel: pad tiles' rows never serialize
        ns = [c[0] for c in chunks]
        streams = [None if s is None else tuple(a[: c[0] * cpt] for a in s)
                   for c in chunks for s, cpt in zip(c[2:4], (bins_cpt, subs_cpt))]
        extras = [c[4:6] for c in chunks] if preserve_order else []
        with stage("exec.download", fused=fused, tiles=n_total) as dl_sp:
            if fused:
                host, extras = fetch_compacted_streams(streams, extras, stage)
            else:
                TRANSFER_COUNTS.add("d2h_sections")
                host = [None if s is None else [_download(a) for a in s]
                        for s in streams]
                extras = [[_download(a) for a in e] for e in extras]
                nbytes = sum(a.nbytes for group in (*host, *extras)
                             if group is not None for a in group)
                TRANSFER_COUNTS.add("bytes_d2h", nbytes)
                dl_sp.set_tag("nbytes", nbytes)
                with stage("exec.restore", streams=len(host)):
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

    def _solve_chunk(self, x_dev, eps_dev, tables, n_chunk: int,
                     capacity: int, tdt, bins_tdt, bins_chunk: int,
                     preserve_order: bool, adaptive: bool,
                     values_fused: bool, prev, resident, sizes, layout0,
                     shard=None):
        """One device batch's frontend, bins encode and halo-round solve
        -> [n_chunk, capacity, bins stream, subbins | None(, local
        sweeps, last round)].  ``prev`` holds a residual frame's previous
        bins per request, ``resident`` (a list) collects each request's
        bins when a chain keeps them on the device.

        With ``shard`` (this rank's block of a sharded batch) the tiles,
        eps and halo-table rows are the block's: the frontend and the
        encodes run on it, the streams come back gathered to the whole
        batch's rows, and the subbins stay the block's (their encode
        waits for the group's width)."""
        b0, b1 = (0, capacity) if shard is None else (shard.lo, shard.hi)
        if values_fused:
            return [n_chunk, capacity, _gathered(
                shard, device.resident_encode_fused(
                    x_dev, eps_dev, tdt, bins_tdt, bins_chunk)), None]
        if adaptive:
            bins_enc, s_init, flags = device.resident_frontend_adaptive(
                x_dev, eps_dev, tdt)
        else:
            bins_enc, bins_m, vals_m = device.resident_quantize(
                x_dev, eps_dev, tdt, preserve_order)
        stream, transform = bins_enc, "delta"
        if prev is not None:
            prev = list(prev)
            if capacity > n_chunk:
                prev.append(bins_enc.new_zeros((capacity - n_chunk,)
                                               + layout0.tile))
            stream = device.residual_tiles(bins_enc, torch.cat(prev)[b0:b1])
            transform = "zigzag"
        # a narrower store wraps, as the reference's astype does
        bins_s = _gathered(shard, device.encode_tiles(
            stream.to(bins_tdt).reshape(b1 - b0, -1), bins_chunk, transform))
        if resident is not None:
            whole = bins_enc if shard is None else shard.gather(bins_enc)
            resident.extend(torch.split(whole[:n_chunk], sizes))
        del bins_enc, stream
        if not preserve_order:
            return [n_chunk, capacity, bins_s, None]
        idx, mask, adj = tables
        max_rounds = n_chunk * layout0.tile_elems + 2
        # only a sharded batch passes its block (spies of the one-device
        # solve keep its signature)
        sharded = {} if shard is None else {"shard": shard}
        if adaptive:
            s_final, local1, last_round, rounds = device.resident_solve(
                flags, idx, mask, max_rounds=max_rounds, adjacency=adj,
                sub0=s_init if shard is None else shard.gather(s_init),
                n_real=n_chunk, **sharded)
            # the stored subbin is the ordered distance climbed above the
            # bin base (0 at invalid cells, whose state never moves);
            # subtracting in the state's own width wraps as the
            # reference's unsigned subtraction does: no widening
            sub = s_final[b0:b1] - s_init
            del s_final, s_init
        else:
            flags = device.resident_flags(bins_m, vals_m, b1 - b0)
            del bins_m, vals_m
            sub, local1, last_round, rounds = device.resident_solve(
                flags, idx, mask, max_rounds=max_rounds, adjacency=adj,
                n_real=n_chunk, **sharded)
            sub = sub[b0:b1]
        TRANSFER_COUNTS.add("d2h_round", rounds)
        return [n_chunk, capacity, bins_s, sub, local1, last_round]

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
        DECODE_COUNTS.add("tiles", n)
        floor = max(CAPACITY_FLOOR, self.plan.batch_tiles)
        parts = []
        pos = 0
        for n_chunk in buckets.plan_tile_chunks(n, floor):
            batch = resident_capacity(n_chunk, floor)
            parts.append(self._decode_chunk(
                items[pos : pos + n_chunk], tile_elems, dtype, order, words,
                batch))
            pos += n_chunk
        if len(parts) == 1:
            out = parts[0]
        else:
            with self._stage("exec.concat", batches=len(parts), tiles=n):
                out = np.concatenate(parts)
        return out.reshape((n,) + tuple(tile))

    def stage_rows(self, items, tile_elems: int, order: bool, words,
                   batch: int) -> list[np.ndarray]:
        """Deserialize a decode batch's tile sections into the kernel's
        host operands: (bitmap, packed[, sub_bitmap, sub_packed]) word
        rows in signed twins and the (batch,) f64 eps; the subbin rows
        only for an order-preserving batch."""
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
        return arrays

    def _decode_chunk(self, items, tile_elems: int, dtype, order: bool,
                      words, batch: int):
        n = len(items)
        DECODE_COUNTS.add("batches")
        buckets.record_batch("decode", n, batch)
        with self._stage("exec.stream_prep", tiles=n, batch=batch):
            arrays = self.stage_rows(items, tile_elems, order, words, batch)
        up = sum(a.nbytes for a in arrays)
        TRANSFER_COUNTS.add("h2d_sections")
        TRANSFER_COUNTS.add("bytes_h2d", up)
        decode = (device.resident_decode_order if order
                  else device.resident_decode_plain)
        with self._stage("exec.decode", tiles=n, batch=batch, fused=True,
                         nbytes_h2d=up):
            out = decode(*[self._put(a) for a in arrays], tile_elems,
                         _TORCH_DTYPE[dtype])
        TRANSFER_COUNTS.add("d2h_values")
        with self._stage("exec.download", tiles=n) as dl_sp:
            out_h = out.cpu().numpy()
            dl_sp.set_tag("nbytes", out_h.nbytes)
        TRANSFER_COUNTS.add("bytes_d2h", out_h.nbytes)
        return out_h[:n]


def _device_key(d: torch.device) -> tuple:
    """(type, index) of a device, a CUDA device without an index read as
    the current one."""
    if d.type == "cuda" and d.index is None:
        return "cuda", torch.cuda.current_device()
    return d.type, d.index


def _gathered(shard, stream):
    """A (bitmap, words, counts) stream of a rank's block rows -> the
    whole batch's rows (every rank's blocks, in rank order); unchanged
    when the batch is not sharded."""
    if shard is None:
        return stream
    return tuple(shard.gather(a) for a in stream)


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
    TRANSFER_COUNTS.add("bytes_d2h_byte_level_saved", word_form - byte_form)
    return [mask[:mask_len], nz[: _granule_len(n_nzbytes, nz.numel())]], "bytes"


def _restore_run(parts, form: str, n_words: int, n_nzbytes: int, udt):
    """Host inverse of :func:`_pick_run` -> the run's words (unsigned)."""
    if form == "words":
        return parts[0][:n_words].view(udt)
    nbytes = n_words * np.dtype(udt).itemsize
    raw = rze.np_unrze_bytes(parts[0], parts[1][:n_nzbytes], nbytes)
    return raw.view(udt)


def fetch_compacted_streams(streams, extras, stage):
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
    empty subbin slots).  The compaction and the totals fetch run under
    ``stage``'s ``exec.compaction`` span, the host's restore after the
    last fetch under its ``exec.restore`` span.  Returns (restored, host
    extras).
    """
    with stage("exec.compaction",
               streams=sum(1 for s in streams if s is not None)):
        live = [(i, device.compact_streams(s[0], s[1]))
                for i, s in enumerate(streams) if s is not None]
        TRANSFER_COUNTS.add("d2h_aux")
        totals = torch.stack([c[3] for _, c in live]).cpu().numpy()
        TRANSFER_COUNTS.add("bytes_d2h", totals.nbytes)
    fetch, forms = [], []
    for (_, (keepmap, kept, words, _)), tot in zip(live, totals):
        n_words, n_kept, nz_words, nz_kept = (int(t) for t in tot)
        kept_parts, kept_form = _pick_run(kept, n_kept, nz_kept)
        word_parts, word_form = _pick_run(words, n_words, nz_words)
        fetch.append(([keepmap], kept_parts, word_parts))
        forms.append((kept_form, word_form))
    TRANSFER_COUNTS.add("d2h_sections")
    fetch_h = [[[t.cpu().numpy() for t in part] for part in f] for f in fetch]
    extras_h = [[t.cpu().numpy() for t in e] for e in extras]
    TRANSFER_COUNTS.add("bytes_d2h", sum(
        a.nbytes for f in fetch_h for part in f for a in part) + sum(
        a.nbytes for e in extras_h for a in e))
    restored = [None] * len(streams)
    with stage("exec.restore", streams=len(live)):
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
