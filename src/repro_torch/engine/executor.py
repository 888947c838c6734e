"""Device-resident executor (port of ``repro.engine.executor``).

A compress group's tiles are uploaded once per device batch (padded to a
bucketed *resident capacity*), quantize -> order flags -> bins encode ->
halo-round subbin solve -> subbin encode run on the device, and one
staged download brings back the (bitmap, words, counts) rows of both
streams plus the solver diagnostics.  The download is the uncompacted
staged form (about the raw field size); the host serializer compacts it.

Decode runs the other way: tile sections are deserialized into chunk
rows on the host, uploaded once per decode batch, decoded by one kernel
and downloaded as values.

``TRANSFER_COUNTS`` counts host<->device crossings by category
(``h2d_tiles``, ``h2d_aux``, ``d2h_aux``, ``d2h_round`` — the one
boolean read back per halo round —, ``d2h_sections``, ``h2d_sections``,
``d2h_values``) plus ``bytes_h2d`` / ``bytes_d2h``.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..codecs.transforms import NP_UNSIGNED
from ..core import bitstream
from ..core.quantize import bin_dtype_for
from . import buckets, device, halo
from .plan import CompressionPlan, TileLayout

TRANSFER_COUNTS: Counter = Counter()

_CHUNK_WORDS = {2: 8192, 4: 4096, 8: 2048}  # word bytes -> words / 16 KiB

CAPACITY_FLOOR = buckets.CAPACITY_FLOOR

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


def reset_transfer_counts() -> None:
    TRANSFER_COUNTS.clear()


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
    arrays)."""

    bins: tuple[np.ndarray, np.ndarray, np.ndarray]   # bitmap, words, counts
    subs: tuple[np.ndarray, np.ndarray, np.ndarray]
    local_sweeps: np.ndarray                          # (n_tiles,) int32
    last_round: np.ndarray                            # (n_tiles,) int32
    bins_cpt: int
    subs_cpt: int


class Executor:
    """Execute half of the engine for one plan on one device."""

    def __init__(self, plan: CompressionPlan, device: torch.device):
        self.plan = plan
        self.device = torch.device(device)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------ compress

    def compress_tiles(self, x_tiles: np.ndarray, eps_tiles: np.ndarray,
                       layouts: tuple[TileLayout, ...], dtype,
                       bins_store=None) -> GroupStreams:
        """Run one order-preserving compress group on the device.

        ``x_tiles`` is the group's concatenated haloed tiles with NaN
        marking every cell outside a field; ``eps_tiles`` the per-tile
        effective bounds; ``bins_store`` the (possibly narrowed) section
        word dtype of the bins stream.
        """
        layout0 = layouts[0]
        tdt = _TORCH_DTYPE[np.dtype(dtype)]
        floor = max(CAPACITY_FLOOR, self.plan.batch_tiles)
        bins_store = np.dtype(bins_store or bin_dtype_for(dtype))
        bins_cpt, bins_chunk = chunks_per_tile(layout0, bins_store)
        sizes = tuple(lay.n_tiles for lay in layouts)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        chunks = []
        for lo, hi in buckets.plan_request_chunks(sizes, floor):
            r0, r1 = int(offsets[lo]), int(offsets[hi])
            n_chunk = r1 - r0
            capacity = resident_capacity(n_chunk, floor)
            idx, mask = halo.group_index(layouts[lo:hi], capacity)
            xc, ec = x_tiles[r0:r1], eps_tiles[r0:r1]
            pad = capacity - n_chunk
            if pad:
                xc = np.concatenate([
                    xc, np.full((pad,) + xc.shape[1:], np.nan, xc.dtype)])
                ec = np.concatenate([ec, np.ones(pad, np.float64)])
            TRANSFER_COUNTS["h2d_tiles"] += 1
            TRANSFER_COUNTS["h2d_aux"] += 3
            TRANSFER_COUNTS["bytes_h2d"] += (xc.nbytes + ec.nbytes
                                             + idx.nbytes + mask.nbytes)
            x_dev, eps_dev = self._put(xc), self._put(ec)
            idx_dev, mask_dev = self._put(idx), self._put(mask)
            bins_enc, bins_m, vals_m = device.resident_quantize(
                x_dev, eps_dev, tdt)
            del x_dev
            flags = device.resident_flags(bins_m, vals_m, capacity)
            del bins_m, vals_m
            bins_s = device.encode_tiles(
                bins_enc.to(_TORCH_DTYPE[bins_store]).reshape(capacity, -1),
                bins_chunk, "delta")
            del bins_enc
            sub, local1, last_round, rounds = device.resident_solve(
                flags, idx_dev, mask_dev,
                max_rounds=n_chunk * layout0.tile_elems + 2)
            TRANSFER_COUNTS["d2h_round"] += rounds
            chunks.append([n_chunk, capacity, bins_s, sub, local1,
                           last_round])

        # the width is picked from the *group* maximum so chunking never
        # changes the subbin stream
        TRANSFER_COUNTS["d2h_aux"] += len(chunks)
        sub_top = max(device.sub_max(c[3]) for c in chunks)
        sub_store = np.dtype(np.int16 if sub_top < 2**15 else np.int32)
        subs_cpt, subs_chunk = chunks_per_tile(layout0, sub_store)
        for c in chunks:
            c.append(device.encode_tiles(
                c[3].to(_TORCH_DTYPE[sub_store]).reshape(c[1], -1),
                subs_chunk, "raw"))

        TRANSFER_COUNTS["d2h_sections"] += 1
        host = [([_download(a) for a in c[2]], [_download(a) for a in c[6]],
                 _download(c[4]), _download(c[5])) for c in chunks]
        TRANSFER_COUNTS["bytes_d2h"] += sum(
            a.nbytes for h in host for a in (*h[0], *h[1], h[2], h[3]))
        ns = [c[0] for c in chunks]
        return GroupStreams(
            _cat_streams([h[0] for h in host], ns, bins_cpt),
            _cat_streams([h[1] for h in host], ns, subs_cpt),
            np.concatenate([h[2][:n] for h, n in zip(host, ns)]),
            np.concatenate([h[3][:n] for h, n in zip(host, ns)]),
            bins_cpt, subs_cpt)

    # ------------------------------------------------------------- decode

    def decode_items(self, items, tile: tuple[int, int, int], dtype,
                     words: tuple[int, int]) -> np.ndarray:
        """Decode an order-preserving tile work-list -> values (n, *tile).

        ``items`` is a list of (container, tile_id, eps_eff) sharing one
        (tile shape, dtype, section words) signature; ``words`` is the
        (bins, subs) section word width in bytes.
        """
        dtype = np.dtype(dtype)
        tile_elems = int(np.prod(tile))
        if words[1] not in _CHUNK_WORDS:
            # header flags promise a subbin stream the sections lack
            raise ValueError("corrupt LOPC container (missing subbin stream)")
        n = len(items)
        if not n:
            return np.zeros((0,) + tuple(tile), dtype)
        floor = max(CAPACITY_FLOOR, self.plan.batch_tiles)
        parts = []
        pos = 0
        for n_chunk in buckets.plan_tile_chunks(n, floor):
            batch = resident_capacity(n_chunk, floor)
            parts.append(self._decode_chunk(
                items[pos : pos + n_chunk], tile_elems, dtype, words, batch))
            pos += n_chunk
        out = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return out.reshape((n,) + tuple(tile))

    def stage_rows(self, items, tile_elems: int, words, batch: int):
        """Deserialize a decode batch's tile sections into the kernel's
        operands, on the device: (bitmap, packed, sub_bitmap, sub_packed)
        word rows in signed twins and the (batch,) f64 eps."""
        def alloc(word):
            chunk_len = _CHUNK_WORDS[word]
            cpt = -(-tile_elems // chunk_len)
            udt = NP_UNSIGNED[word]
            bitmap = np.zeros((batch * cpt, chunk_len // (word * 8)), udt)
            packed = np.zeros((batch * cpt, chunk_len), udt)
            return bitmap, packed, cpt

        bitmap, packed, bins_cpt = alloc(words[0])
        sub_bitmap, sub_packed, subs_cpt = alloc(words[1])
        eps = np.ones(batch, np.float64)
        for j, (c, t, eps_eff) in enumerate(items):
            eps[j] = eps_eff
            bins_b, sub_b = c.tile_payloads(t)
            _fill_rows(bitmap, packed, bins_b, j * bins_cpt, bins_cpt)
            _fill_rows(sub_bitmap, sub_packed, sub_b, j * subs_cpt, subs_cpt)
        arrays = [a.view(f"<i{a.dtype.itemsize}")
                  for a in (bitmap, packed, sub_bitmap, sub_packed)] + [eps]
        TRANSFER_COUNTS["h2d_sections"] += 1
        TRANSFER_COUNTS["bytes_h2d"] += sum(a.nbytes for a in arrays)
        return [self._put(a) for a in arrays]

    def _decode_chunk(self, items, tile_elems: int, dtype, words, batch: int):
        operands = self.stage_rows(items, tile_elems, words, batch)
        out = device.resident_decode_order(*operands, tile_elems,
                                           _TORCH_DTYPE[dtype])
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


def _cat_streams(parts, ns, cpt):
    """Concatenate per-chunk encoded streams, keeping only real-tile
    chunk rows so downstream ``j * cpt`` section slicing is unchanged."""
    sliced = [tuple(a[: n * cpt] for a in p) for p, n in zip(parts, ns)]
    if len(sliced) == 1:
        return sliced[0]
    return tuple(np.concatenate(cols) for cols in zip(*sliced))


@lru_cache(maxsize=64)
def default_executor(plan: CompressionPlan, device: torch.device) -> Executor:
    """Shared executors, one per (plan, device)."""
    return Executor(plan, device)
