"""Host-side byte serialization (a numpy copy of ``repro.core.bitstream``).

On a real pod this is the host-offload path of the storage DMA: devices
produce fixed-shape transform outputs (bitmaps, compacted words, counts)
and the host assembles the variable-length byte stream.  Everything here
is vectorized numpy — deterministic, byte-stable across platforms
(little-endian on-disk order).

Container layout (all little-endian):

  [4s magic][u8 version][u8 flags][u8 dtype][u8 ndim][u64 shape*ndim]
  [u8 eb_mode][f64 eb][f64 eps_abs][u32 crc32 of body]

(The solver sweep count is intentionally NOT serialized: the byte stream
must be identical across solver schedules — the paper's bit-parity
guarantee. Sweep counts are diagnostics, reported via CompressStats.)
  body: sections, each [u8 tag][u64 len][payload]

Container v2 (the tiled engine format) keeps the same header prefix but
replaces the single whole-field body with an *indexed per-tile section
table*, enabling embarrassingly-parallel and partial (region-of-
interest) decode:

  [4s magic][u8 version=2][u8 flags][u8 dtype][u8 ndim][u64 shape*ndim]
  [u8 eb_mode][f64 eb][f64 eps_abs]
  [u64 tile_shape*3][u64 grid*3][u32 n_tiles][u8 n_extra]
  extras dir : n_extra x [u8 tag][u64 off][u64 len]
  tile index : n_tiles x [u64 bins_off][u64 bins_len]
                         [u64 sub_off][u64 sub_len][u32 crc32]
  [u32 crc32 of every byte above]
  data area  : concatenated payloads (offsets relative to its start)

Integrity is split so partial decode stays cheap: one crc over the
header+index, one crc *per tile* over its payload bytes.  A reader can
verify and decode any tile subset without touching the rest.

Container v3 (the temporal chain format, ``repro.temporal``) stores a
whole *time series* of one field shape: a frame index of keyframes and
bin-residual frames, each frame carrying its own per-tile section table
and crc, so ``decompress_frame(t)`` touches at most one keyframe plus
the residual run back to it:

  [4s magic][u8 version=3][u8 flags][u8 dtype][u8 ndim][u64 shape*ndim]
  [u8 eb_mode][f64 eb][f64 eps_abs]
  [u64 tile_shape*3][u64 grid*3]
  [u32 n_frames][u32 keyframe_interval][u32 n_tiles][u8 n_extra]
  extras dir : n_extra x [u8 tag][u64 off][u64 len]
  frame index: n_frames x [u8 kind][u8 fflags][u64 off][u64 len][u32 crc32]
  [u32 crc32 of every byte above]
  data area  : concatenated frame payloads (offsets from its start)

``kind`` is 0 (keyframe: bins stored like a v2 snapshot) or 1 (residual:
bins stored as the difference to the previous frame's bins); ``fflags``
is a per-frame flags byte (bit 1 = FLAG_HAS_NONFINITE).  A frame payload
is itself a small indexed table (see serialize_frame_payload):

  [u32 n_tiles]
  tile table  : n_tiles x [u64 bins_len][u64 sub_len]
  [u64 nonfinite_len]
  concatenated per-tile bins+subbins payloads, then the nonfinite sidecar

Adaptive-eb containers (v2 and v3) additionally carry a per-tile
eb-ladder extras section (TAG_EB_LADDER, present iff FLAG_ADAPTIVE_EB):

  [u8 version=1][u8 k_max][u16 reserved=0][u32 n_tiles][u8 index x n_tiles]

tile t decodes at eps_abs * 2**-index[t]; absent section = index 0.

The byte-level normative description of all three formats lives in
docs/format.md.

RZE section payload:

  [u32 n_chunks][u32 chunk_len][u8 word_bytes][u8 final_rze]
  [u64 bitmap_keepmap_len][keepmap][u64 bitmap_kept_len][kept words]
  [u64 data_len][nonzero words]          (final_rze=1: the three streams
                                          above are RZE_1-compressed once
                                          more at byte granularity)
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass

import numpy as np

from ..codecs.rze import (
    np_repeat_eliminate,
    np_repeat_restore,
    np_rze_bytes,
    np_unrze_bytes,
)

MAGIC = b"LOPC"
VERSION = 1
VERSION_TILED = 2
VERSION_CHAIN = 3

DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}
CODES_DTYPE = {v: k for k, v in DTYPE_CODES.items()}
EB_MODES = {"abs": 0, "noa": 1}
MODES_EB = {v: k for k, v in EB_MODES.items()}

# Canonical section tags (shared by the v1 body and the v2 extras dir).
TAG_BINS = 1
TAG_SUBBINS = 2
TAG_NONFINITE = 3
TAG_EB_LADDER = 4

# Container flags byte (shared by v1 and v2 writers/readers).
FLAG_ORDER_PRESERVING = 1
FLAG_HAS_NONFINITE = 2
FLAG_ADAPTIVE_EB = 4

# v2 extras must be understood to be decoded safely: reject unknowns.
V2_KNOWN_TAGS = frozenset({TAG_NONFINITE, TAG_EB_LADDER})

# v3 (chain) frame kinds + chain-level extras (the nonfinite sidecar is
# per frame, inside the frame payload; the eb ladder is chain-wide).
FRAME_KEY = 0
FRAME_RESIDUAL = 1
V3_KNOWN_TAGS = frozenset({TAG_EB_LADDER})


# --------------------------------------------------------- eb-ladder section
#
# Adaptive-eb containers carry one ladder index per tile: tile t is
# quantized at eps_abs * 2**-k[t], where ``eps_abs`` is the header bound
# (the *loosest* rung).  Containers without the section decode at index
# 0 everywhere — i.e. the header bound — which is exactly the uniform-eb
# behaviour, so pre-adaptive readers and writers interoperate.
#
#   [u8 version=1][u8 k_max][u16 reserved=0][u32 n_tiles][u8 index x n_tiles]
#
# ``k_max`` bounds every stored index (0 <= index <= k_max).

EB_LADDER_VERSION = 1
EB_LADDER_K_MAX = 3  # rungs eps_abs * 2**-k for k in 0..K_MAX (4 rungs)


def serialize_eb_ladder(indices, k_max: int = EB_LADDER_K_MAX) -> bytes:
    idx = np.ascontiguousarray(indices, np.uint8)
    if idx.ndim != 1:
        raise ValueError("eb-ladder indices must be 1-D")
    if not 0 <= int(k_max) <= 7:
        raise ValueError(f"eb-ladder k_max {k_max} out of range")
    if idx.size and int(idx.max()) > int(k_max):
        raise ValueError("eb-ladder index exceeds k_max")
    w = Writer()
    w.pack("BBH", EB_LADDER_VERSION, int(k_max), 0)
    w.pack("I", idx.size)
    w.raw(idx.tobytes())
    return w.getvalue()


def parse_eb_ladder(payload: bytes, n_tiles: int) -> tuple[int, np.ndarray]:
    """-> (k_max, per-tile ladder index uint8 array). Strict: rejects
    bad version/reserved/count/range and trailing bytes."""
    r = Reader(payload)
    version, k_max, reserved = r.unpack("BBH")
    if version != EB_LADDER_VERSION:
        raise ValueError(f"unsupported eb-ladder version {version}")
    if reserved != 0:
        raise ValueError("corrupt LOPC container (eb-ladder reserved != 0)")
    if k_max > 7:
        raise ValueError(f"corrupt LOPC container (eb-ladder k_max {k_max})")
    n = r.unpack("I")
    if n != n_tiles:
        raise ValueError(
            f"corrupt LOPC container (eb-ladder holds {n} tiles, "
            f"grid expects {n_tiles})"
        )
    idx = np.frombuffer(r.raw(n), np.uint8)
    if r.off != len(payload):
        raise ValueError("corrupt LOPC container (eb-ladder length mismatch)")
    if idx.size and int(idx.max()) > k_max:
        raise ValueError("corrupt LOPC container (eb-ladder index > k_max)")
    return int(k_max), idx


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(bytes(b))

    def pack(self, fmt: str, *vals):
        self.parts.append(struct.pack("<" + fmt, *vals))

    def lp(self, b: bytes):  # length-prefixed
        self.pack("Q", len(b))
        self.raw(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off : self.off + n]
        if len(b) != n:
            raise ValueError("truncated stream")
        self.off += n
        return b

    def unpack(self, fmt: str):
        size = struct.calcsize("<" + fmt)
        vals = struct.unpack("<" + fmt, self.raw(size))
        return vals if len(vals) > 1 else vals[0]

    def lp(self) -> bytes:
        return self.raw(self.unpack("Q"))


# ------------------------------------------------------------ byte sources
#
# Containers parse a small head (header + index) and then slice tile /
# frame payloads lazily.  The slicing goes through a *byte source* so the
# same reader works over an in-memory blob and over a file on disk (the
# store's payload files): a ``bytes`` object is a valid source as-is, and
# :class:`FileSource` provides positional reads that never load the full
# payload (the tile-addressable read path of ``repro.store``).

class FileSource:
    """Positional (pread-style) byte source over a file.

    Reads are stateless per call — ``os.pread`` where available, a
    locked seek+read otherwise — so one source may serve concurrent
    readers.  ``bytes_read`` counts payload bytes actually fetched,
    the probe tests use to assert partial reads stay partial.
    """

    def __init__(self, path):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        self._lock = threading.Lock()
        self.bytes_read = 0

    def pread(self, off: int, n: int) -> bytes:
        if n <= 0:
            return b""
        if hasattr(os, "pread"):
            b = os.pread(self._fd, n, off)
        else:  # pragma: no cover - non-POSIX fallback
            with self._lock:
                os.lseek(self._fd, off, os.SEEK_SET)
                b = os.read(self._fd, n)
        with self._lock:  # counter only; the read itself is stateless
            self.bytes_read += len(b)
        return b

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "FileSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; close() is the real API
        try:
            if getattr(self, "_fd", None) is not None:
                os.close(self._fd)
        except OSError:  # pragma: no cover
            pass
        self._fd = None


def _source_slice(source, off: int, n: int) -> bytes:
    """Slice ``n`` bytes at ``off`` out of a bytes-or-FileSource."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source[off : off + n])
    return source.pread(off, n)


def _source_size(source) -> int:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return len(source)
    return source.size()


# ------------------------------------------------------------- RZE section

def _maybe_final_rze(stream: bytes) -> tuple[int, bytes]:
    """Apply the byte-granularity RZE_1 stage if it shrinks the stream."""
    arr = np.frombuffer(stream, np.uint8)
    bitmap, nz = np_rze_bytes(arr)
    w = Writer()
    w.pack("Q", arr.size)
    w.lp(bitmap.tobytes())
    w.raw(nz.tobytes())
    packed = w.getvalue()
    if len(packed) < len(stream):
        return 1, packed
    return 0, stream


def _undo_final_rze(flag: int, payload: bytes) -> bytes:
    if not flag:
        return payload
    r = Reader(payload)
    n = r.unpack("Q")
    bitmap = np.frombuffer(r.lp(), np.uint8)
    nz = np.frombuffer(r.raw(len(payload) - r.off), np.uint8)
    return np_unrze_bytes(bitmap, nz, n).tobytes()


def _emit_rze_section(bitmap: np.ndarray, data: np.ndarray, n_chunks: int,
                      chunk_len: int, word: int) -> bytes:
    """Assemble one RZE section from its bitmap rows and the already-
    compacted nonzero words (shared by both serializer entry points, so
    raw-row and flat-compacted inputs emit identical bytes)."""
    keepmap, kept = np_repeat_eliminate(
        np.ascontiguousarray(bitmap).reshape(-1))
    inner = Writer()
    inner.lp(keepmap.tobytes())
    inner.lp(kept.tobytes())
    inner.lp(data.tobytes())
    flag, payload = _maybe_final_rze(inner.getvalue())
    w = Writer()
    w.pack("IIBB", n_chunks, chunk_len, word, flag)
    w.raw(payload)
    return w.getvalue()


def serialize_rze_section(bitmap: np.ndarray, packed: np.ndarray,
                          counts: np.ndarray, compacted: bool = True) -> bytes:
    """Serialize device RZE output. counts are NOT stored (recomputed
    from the bitmap popcount on decode).

    ``compacted=False`` accepts the *raw* (uncompacted) word rows the
    engine's staged executor path downloads — the nonzero words are
    extracted here with one boolean index, producing byte-identical
    sections without the device-side compaction scatter.
    """
    n_chunks, chunk_len = packed.shape
    word = packed.dtype.itemsize
    # variable-length nonzero words per chunk
    packed = np.ascontiguousarray(packed)
    if compacted:
        mask = np.arange(chunk_len)[None, :] < np.asarray(counts)[:, None]
    else:
        mask = packed != 0
    return _emit_rze_section(bitmap, packed[mask], n_chunks, chunk_len, word)


def serialize_rze_section_flat(bitmap: np.ndarray, data: np.ndarray,
                               chunk_len: int) -> bytes:
    """Serialize from the device-compacted transport form: ``bitmap``
    rows plus ``data``, the rows' nonzero words already front-packed in
    row-major order (``device.compact_streams``).  The words a boolean
    index over raw rows would extract are exactly these, in this order,
    so sections equal :func:`serialize_rze_section` byte-for-byte."""
    return _emit_rze_section(bitmap, data, bitmap.shape[0], chunk_len,
                             bitmap.dtype.itemsize)


def deserialize_rze_section(buf: bytes):
    """-> (bitmap (C, L//W) uintW, packed (C, L) uintW) zero-padded."""
    r = Reader(buf)
    n_chunks, chunk_len, word, flag = r.unpack("IIBB")
    dt = np.dtype(f"<u{word}")
    w = word * 8
    payload = _undo_final_rze(flag, buf[r.off :])
    r2 = Reader(payload)
    keepmap = np.frombuffer(r2.lp(), np.uint8)
    kept = np.frombuffer(r2.lp(), dt)
    data = np.frombuffer(r2.lp(), dt)
    n_bitmap_words = n_chunks * (chunk_len // w)
    bitmap = np_repeat_restore(keepmap, kept, n_bitmap_words, dt).reshape(
        n_chunks, chunk_len // w
    )
    if n_chunks == 0:  # fully-trimmed section (every chunk was all-zero)
        return bitmap, np.zeros((0, chunk_len), dt)
    # counts from popcount of bitmap rows
    bits = np.unpackbits(bitmap.astype(f">u{word}").view(np.uint8).reshape(n_chunks, -1), axis=1)
    counts = bits.sum(axis=1)
    packed = np.zeros((n_chunks, chunk_len), dt)
    mask = np.arange(chunk_len)[None, :] < counts[:, None]
    packed[mask] = data
    return bitmap.astype(dt), packed


# ------------------------------------------------------------- container

@dataclass
class Header:
    dtype: np.dtype
    shape: tuple[int, ...]
    eb_mode: str
    eb: float
    eps_abs: float
    flags: int = 0


def write_container(header: Header, sections: dict[int, bytes]) -> bytes:
    body = Writer()
    for tag, payload in sorted(sections.items()):
        body.pack("BQ", tag, len(payload))
        body.raw(payload)
    body_b = body.getvalue()
    w = Writer()
    w.raw(MAGIC)
    w.pack("BBBB", VERSION, header.flags, DTYPE_CODES[np.dtype(header.dtype)], len(header.shape))
    w.pack("Q" * len(header.shape), *header.shape)
    w.pack("B", EB_MODES[header.eb_mode])
    w.pack("dd", header.eb, header.eps_abs)
    w.pack("I", zlib.crc32(body_b) & 0xFFFFFFFF)
    w.raw(body_b)
    return w.getvalue()


def container_version(blob: bytes) -> int:
    """Peek the version byte (both formats share the magic prefix)."""
    if len(blob) < 5 or blob[:4] != MAGIC:
        raise ValueError("not an LOPC container")
    return blob[4]


def read_container(blob: bytes) -> tuple[Header, dict[int, bytes]]:
    r = Reader(blob)
    if r.raw(4) != MAGIC:
        raise ValueError("not an LOPC container")
    version, flags, dtc, ndim = r.unpack("BBBB")
    if version != VERSION:
        raise ValueError(f"unsupported container version {version}")
    shape = tuple(np.atleast_1d(r.unpack("Q" * ndim)).tolist()) if ndim > 1 else (r.unpack("Q"),)
    eb_mode = MODES_EB[r.unpack("B")]
    eb, eps_abs = r.unpack("dd")
    crc = r.unpack("I")
    body = blob[r.off :]
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise ValueError("corrupt LOPC container (crc mismatch)")
    sections = {}
    r2 = Reader(body)
    while r2.off < len(body):
        tag, n = r2.unpack("BQ")
        sections[tag] = r2.raw(n)
    header = Header(CODES_DTYPE[dtc], shape, eb_mode, eb, eps_abs, flags)
    return header, sections


# ---------------------------------------------------------- container v2

@dataclass
class TileEntry:
    bins_off: int
    bins_len: int
    sub_off: int
    sub_len: int
    crc: int


_TILE_ENTRY_FMT = "QQQQI"


def write_container_v2(
    header: Header,
    tile_shape: tuple[int, int, int],
    grid: tuple[int, int, int],
    tiles: list[tuple[bytes, bytes]],
    extra: dict[int, bytes] | None = None,
) -> bytes:
    """Assemble a tiled (v2) container.

    ``tiles`` holds one ``(bins_payload, subbins_payload)`` pair per tile
    in row-major grid order (subbins payload empty when the stream is not
    order-preserving).  ``extra`` carries whole-field sidecars such as
    the non-finite section.
    """
    extra = extra or {}
    for tag in extra:
        if tag not in V2_KNOWN_TAGS:
            raise ValueError(f"unknown v2 section tag {tag}")
    data = Writer()
    entries = []
    off = 0
    for bins_b, sub_b in tiles:
        crc = zlib.crc32(sub_b, zlib.crc32(bins_b)) & 0xFFFFFFFF
        entries.append(TileEntry(off, len(bins_b), off + len(bins_b),
                                 len(sub_b), crc))
        data.raw(bins_b)
        data.raw(sub_b)
        off += len(bins_b) + len(sub_b)
    extra_dir = []
    for tag, payload in sorted(extra.items()):
        extra_dir.append((tag, off, len(payload)))
        data.raw(payload)
        off += len(payload)

    w = Writer()
    w.raw(MAGIC)
    w.pack("BBBB", VERSION_TILED, header.flags,
           DTYPE_CODES[np.dtype(header.dtype)], len(header.shape))
    w.pack("Q" * len(header.shape), *header.shape)
    w.pack("B", EB_MODES[header.eb_mode])
    w.pack("dd", header.eb, header.eps_abs)
    w.pack("QQQ", *tile_shape)
    w.pack("QQQ", *grid)
    w.pack("IB", len(entries), len(extra_dir))
    for tag, eoff, elen in extra_dir:
        w.pack("BQQ", tag, eoff, elen)
    for e in entries:
        w.pack(_TILE_ENTRY_FMT, e.bins_off, e.bins_len, e.sub_off,
               e.sub_len, e.crc)
    head = w.getvalue()
    return head + struct.pack("<I", zlib.crc32(head) & 0xFFFFFFFF) + data.getvalue()


@dataclass
class ContainerV2:
    """Parsed v2 container: header + tile index over a lazy byte source.

    Tile payloads are sliced (and crc-verified) lazily, so a reader can
    decode any subset of tiles — the basis of parallel and ROI decode.
    ``source`` is either the original blob bytes or a :class:`FileSource`
    (see ``open_container_v2``): a file-backed reader fetches only the
    head plus the payload bytes of the tiles actually decoded.
    """

    header: Header
    tile_shape: tuple[int, int, int]
    grid: tuple[int, int, int]
    entries: list[TileEntry]
    extra: dict[int, tuple[int, int]]
    data_off: int
    source: bytes | FileSource

    @property
    def n_tiles(self) -> int:
        return len(self.entries)

    def _slice(self, off: int, n: int) -> bytes:
        b = _source_slice(self.source, self.data_off + off, n)
        if len(b) != n:
            raise ValueError("truncated stream")
        return b

    def tile_payloads(self, i: int) -> tuple[bytes, bytes]:
        e = self.entries[i]
        bins_b = self._slice(e.bins_off, e.bins_len)
        sub_b = self._slice(e.sub_off, e.sub_len)
        if (zlib.crc32(sub_b, zlib.crc32(bins_b)) & 0xFFFFFFFF) != e.crc:
            raise ValueError(f"corrupt LOPC container (tile {i} crc mismatch)")
        return bins_b, sub_b

    def extra_section(self, tag: int) -> bytes:
        off, n = self.extra[tag]
        return self._slice(off, n)

    def eb_ladder(self) -> np.ndarray:
        """Per-tile eb-ladder index k (tile eps = header eps_abs * 2**-k).

        The section must be present exactly when FLAG_ADAPTIVE_EB is set;
        containers without either decode as index 0 everywhere (uniform
        eb at the header bound), which keeps old containers readable.
        """
        has_flag = bool(self.header.flags & FLAG_ADAPTIVE_EB)
        has_section = TAG_EB_LADDER in self.extra
        if has_flag != has_section:
            raise ValueError(
                "corrupt LOPC container (adaptive-eb flag and eb-ladder "
                "section must appear together)"
            )
        if not has_section:
            return np.zeros(self.n_tiles, np.uint8)
        _, idx = parse_eb_ladder(self.extra_section(TAG_EB_LADDER),
                                 self.n_tiles)
        return idx

    def stream_words(self) -> tuple[int, int]:
        """(bins, subbins) section word width in bytes.

        Sections are self-describing (RZE header byte 8), so readers
        learn the stored width — possibly narrowed by the writer, see
        engine — without format versioning; 0 when there is no subbin
        stream.  All tiles of a container share one width per stream,
        so any present tile answers; sparse shard containers (cluster
        layer) leave non-owned entries empty, hence the scan rather
        than ``entries[0]``.
        """
        e = next((e for e in self.entries if e.bins_len > 0), None)
        if e is None:
            raise ValueError("corrupt LOPC container (no tile payloads)")
        bins_w = self._slice(e.bins_off, e.bins_len)[8]
        sub_w = self._slice(e.sub_off, e.sub_len)[8] if e.sub_len else 0
        # this byte is only covered by the per-tile crc, which has not
        # been checked yet — reject garbage widths as corruption here
        # rather than as a KeyError deep in the decode path
        if bins_w not in (2, 4, 8) or sub_w not in (0, 2, 4, 8):
            raise ValueError("corrupt LOPC container (bad section word size)")
        return int(bins_w), int(sub_w)


def _parse_container_v2(head: bytes, total: int, source) -> ContainerV2:
    """Parse a v2 head (``head`` must cover header + index) and bind the
    resulting reader to ``source`` for lazy payload slicing; ``total`` is
    the full container length, for the data-area bound check."""
    r = Reader(head)
    if r.raw(4) != MAGIC:
        raise ValueError("not an LOPC container")
    version, flags, dtc, ndim = r.unpack("BBBB")
    if version != VERSION_TILED:
        raise ValueError(f"unsupported container version {version}")
    if dtc not in CODES_DTYPE:
        raise ValueError(f"corrupt LOPC container (dtype code {dtc})")
    if ndim < 1 or ndim > 3:
        raise ValueError(f"corrupt LOPC container (ndim={ndim})")
    shape = tuple(np.atleast_1d(r.unpack("Q" * ndim)).tolist()) if ndim > 1 else (r.unpack("Q"),)
    mode_code = r.unpack("B")
    if mode_code not in MODES_EB:
        raise ValueError(f"corrupt LOPC container (eb mode {mode_code})")
    eb_mode = MODES_EB[mode_code]
    eb, eps_abs = r.unpack("dd")
    tile_shape = tuple(r.unpack("QQQ"))
    grid = tuple(r.unpack("QQQ"))
    if min(tile_shape) < 1 or min(grid) < 1:
        raise ValueError("corrupt LOPC container (zero tile/grid extent)")
    n_tiles, n_extra = r.unpack("IB")
    extra = {}
    for _ in range(n_extra):
        tag, off, n = r.unpack("BQQ")
        if tag not in V2_KNOWN_TAGS:
            raise ValueError(f"unknown v2 section tag {tag}")
        extra[tag] = (off, n)
    entries = [TileEntry(*r.unpack(_TILE_ENTRY_FMT)) for _ in range(n_tiles)]
    head_crc_expected = zlib.crc32(head[: r.off]) & 0xFFFFFFFF
    if r.unpack("I") != head_crc_expected:
        raise ValueError("corrupt LOPC container (index crc mismatch)")
    data_off = r.off
    if n_tiles != int(np.prod(grid)):
        raise ValueError("corrupt LOPC container (tile count/grid mismatch)")
    end = max(
        [e.sub_off + e.sub_len for e in entries]
        + [off + n for off, n in extra.values()]
        + [0]
    )
    if data_off + end > total:
        raise ValueError("truncated stream")
    header = Header(CODES_DTYPE[dtc], shape, eb_mode, eb, eps_abs, flags)
    return ContainerV2(header, tile_shape, grid, entries, extra, data_off,
                       source)


def read_container_v2(blob: bytes) -> ContainerV2:
    return _parse_container_v2(blob, len(blob), blob)


# The head of a tiled container is header + extras dir + tile index —
# small (36 bytes per tile) but not fixed-size, so a file-backed open
# probes a prefix and grows it geometrically until the index parses.
# 4 KiB covers ~110 tiles in one read without swallowing small payload
# files whole (partial reads must stay partial even for small arrays).
_HEAD_PROBE = 4096


def open_container_v2(source: FileSource) -> ContainerV2:
    """Parse a v2 container over a positional byte source.

    Only the head (header + tile index) is fetched here; tile payloads
    are read on demand via ``tile_payloads`` — a region-of-interest
    decode of a stored container touches the head plus exactly the
    payload byte ranges of the tiles it needs.
    """
    total = _source_size(source)
    head = _source_slice(source, 0, min(_HEAD_PROBE, total))
    while True:
        try:
            return _parse_container_v2(head, total, source)
        except ValueError as e:
            # grow the probe only when the head itself ran short; a
            # corrupt head (bad magic, crc mismatch, unknown tag) raises
            # the same error however much of the file we fetch.  Growth
            # fetches only the missing suffix — never re-reads bytes.
            if len(head) >= total or str(e) != "truncated stream":
                raise
            n = min(len(head) * 4, total)
            head += _source_slice(source, len(head), n - len(head))


# ---------------------------------------------------------- container v3

@dataclass
class FrameEntry:
    kind: int    # FRAME_KEY | FRAME_RESIDUAL
    flags: int   # per-frame flags byte (FLAG_HAS_NONFINITE)
    off: int
    length: int
    crc: int


_FRAME_ENTRY_FMT = "BBQQI"


def serialize_frame_payload(tiles: list[tuple[bytes, bytes]],
                            nonfinite: bytes = b"") -> bytes:
    """Assemble one frame's payload: an indexed per-tile section table
    (bins stream first — the keyframe bins or the temporal residual —
    then the frame's own subbin stream) plus the frame's optional
    non-finite sidecar."""
    w = Writer()
    w.pack("I", len(tiles))
    for bins_b, sub_b in tiles:
        w.pack("QQ", len(bins_b), len(sub_b))
    w.pack("Q", len(nonfinite))
    for bins_b, sub_b in tiles:
        w.raw(bins_b)
        w.raw(sub_b)
    w.raw(nonfinite)
    return w.getvalue()


def parse_frame_payload(payload: bytes,
                        n_tiles: int) -> tuple[list[tuple[bytes, bytes]], bytes]:
    """-> (per-tile (bins, sub) payload pairs, nonfinite sidecar)."""
    r = Reader(payload)
    n = r.unpack("I")
    if n != n_tiles:
        raise ValueError(
            f"corrupt LOPC chain (frame holds {n} tiles, chain grid "
            f"expects {n_tiles})"
        )
    lens = [r.unpack("QQ") for _ in range(n)]
    nonfinite_len = r.unpack("Q")
    tiles = [(r.raw(bl), r.raw(sl)) for bl, sl in lens]
    nonfinite = r.raw(nonfinite_len)
    if r.off != len(payload):
        raise ValueError("corrupt LOPC chain (frame payload length mismatch)")
    return tiles, nonfinite


def write_container_v3(
    header: Header,
    tile_shape: tuple[int, int, int],
    grid: tuple[int, int, int],
    keyframe_interval: int,
    frames: list[tuple[int, int, bytes]],
    extra: dict[int, bytes] | None = None,
) -> bytes:
    """Assemble a chain (v3) container.

    ``frames`` holds one ``(kind, frame_flags, payload)`` triple per
    frame in time order (payloads from :func:`serialize_frame_payload`);
    ``keyframe_interval`` is the committed keyframe stride (0 = only
    frame 0 is a keyframe).  ``header.shape`` is ONE frame's shape; the
    frame count lives in the chain index.
    """
    extra = extra or {}
    for tag in extra:
        if tag not in V3_KNOWN_TAGS:
            raise ValueError(f"unknown v3 section tag {tag}")
    if not frames:
        raise ValueError("a chain needs at least one frame")
    if frames[0][0] != FRAME_KEY:
        raise ValueError("frame 0 of a chain must be a keyframe")
    data = Writer()
    entries = []
    off = 0
    for kind, fflags, payload in frames:
        if kind not in (FRAME_KEY, FRAME_RESIDUAL):
            raise ValueError(f"unknown frame kind {kind}")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        entries.append(FrameEntry(kind, fflags, off, len(payload), crc))
        data.raw(payload)
        off += len(payload)
    extra_dir = []
    for tag, payload in sorted(extra.items()):
        extra_dir.append((tag, off, len(payload)))
        data.raw(payload)
        off += len(payload)

    w = Writer()
    w.raw(MAGIC)
    w.pack("BBBB", VERSION_CHAIN, header.flags,
           DTYPE_CODES[np.dtype(header.dtype)], len(header.shape))
    w.pack("Q" * len(header.shape), *header.shape)
    w.pack("B", EB_MODES[header.eb_mode])
    w.pack("dd", header.eb, header.eps_abs)
    w.pack("QQQ", *tile_shape)
    w.pack("QQQ", *grid)
    w.pack("IIIB", len(entries), keyframe_interval,
           int(np.prod(grid)), len(extra_dir))
    for tag, eoff, elen in extra_dir:
        w.pack("BQQ", tag, eoff, elen)
    for e in entries:
        w.pack(_FRAME_ENTRY_FMT, e.kind, e.flags, e.off, e.length, e.crc)
    head = w.getvalue()
    return head + struct.pack("<I", zlib.crc32(head) & 0xFFFFFFFF) + data.getvalue()


@dataclass
class ContainerV3:
    """Parsed v3 chain: header + frame index over a lazy byte source.

    Frame payloads are sliced (and crc-verified) lazily, so a reader can
    decode any frame run — the basis of ``decompress_frame``'s
    keyframe-bounded random access.  Like :class:`ContainerV2`, the
    ``source`` may be the blob bytes or a :class:`FileSource`; the store
    layer additionally builds these views directly from its manifest
    (frame index in json, payload file as the data area, ``data_off=0``).
    """

    header: Header
    tile_shape: tuple[int, int, int]
    grid: tuple[int, int, int]
    keyframe_interval: int
    entries: list[FrameEntry]
    # tag -> (off, len) into the data area, or the raw section bytes
    # directly (manifest-built store views keep chain-level extras in
    # the manifest, not the payload file, so frame appends can extend
    # the file in place)
    extra: dict[int, tuple[int, int] | bytes]
    data_off: int
    source: bytes | FileSource

    @property
    def n_frames(self) -> int:
        return len(self.entries)

    @property
    def n_tiles(self) -> int:
        return int(np.prod(self.grid))

    def extra_section(self, tag: int) -> bytes:
        loc = self.extra[tag]
        if isinstance(loc, (bytes, bytearray)):
            return bytes(loc)
        off, n = loc
        b = _source_slice(self.source, self.data_off + off, n)
        if len(b) != n:
            raise ValueError("truncated stream")
        return b

    def eb_ladder(self) -> np.ndarray:
        """Per-tile eb-ladder index, chain-wide (every frame of a chain
        shares one ladder).  Same flag/section pairing rule as v2."""
        has_flag = bool(self.header.flags & FLAG_ADAPTIVE_EB)
        has_section = TAG_EB_LADDER in self.extra
        if has_flag != has_section:
            raise ValueError(
                "corrupt LOPC container (adaptive-eb flag and eb-ladder "
                "section must appear together)"
            )
        if not has_section:
            return np.zeros(self.n_tiles, np.uint8)
        _, idx = parse_eb_ladder(self.extra_section(TAG_EB_LADDER),
                                 self.n_tiles)
        return idx

    def frame_payload(self, t: int) -> bytes:
        e = self.entries[t]
        b = _source_slice(self.source, self.data_off + e.off, e.length)
        if len(b) != e.length:
            raise ValueError("truncated stream")
        if (zlib.crc32(b) & 0xFFFFFFFF) != e.crc:
            raise ValueError(f"corrupt LOPC chain (frame {t} crc mismatch)")
        return b

    def frame_tiles(self, t: int) -> tuple[list[tuple[bytes, bytes]], bytes]:
        """Parsed payload of frame ``t`` -> (tile sections, nonfinite)."""
        return parse_frame_payload(self.frame_payload(t), self.n_tiles)

    def keyframe_before(self, t: int) -> int:
        """Index of the latest keyframe at or before frame ``t`` — the
        start of the (bounded) residual run a random-access decode
        replays."""
        if not 0 <= t < self.n_frames:
            raise ValueError(f"frame {t} out of range (chain has "
                             f"{self.n_frames} frames)")
        for k in range(t, -1, -1):
            if self.entries[k].kind == FRAME_KEY:
                return k
        raise ValueError("corrupt LOPC chain (no keyframe before frame)")


def read_container_v3(blob: bytes) -> ContainerV3:
    r = Reader(blob)
    if r.raw(4) != MAGIC:
        raise ValueError("not an LOPC container")
    version, flags, dtc, ndim = r.unpack("BBBB")
    if version != VERSION_CHAIN:
        raise ValueError(f"unsupported container version {version}")
    if dtc not in CODES_DTYPE:
        raise ValueError(f"corrupt LOPC container (dtype code {dtc})")
    if ndim < 1 or ndim > 3:
        raise ValueError(f"corrupt LOPC container (ndim={ndim})")
    shape = tuple(np.atleast_1d(r.unpack("Q" * ndim)).tolist()) if ndim > 1 else (r.unpack("Q"),)
    mode_code = r.unpack("B")
    if mode_code not in MODES_EB:
        raise ValueError(f"corrupt LOPC container (eb mode {mode_code})")
    eb_mode = MODES_EB[mode_code]
    eb, eps_abs = r.unpack("dd")
    tile_shape = tuple(r.unpack("QQQ"))
    grid = tuple(r.unpack("QQQ"))
    if min(tile_shape) < 1 or min(grid) < 1:
        raise ValueError("corrupt LOPC container (zero tile/grid extent)")
    n_frames, keyframe_interval, n_tiles, n_extra = r.unpack("IIIB")
    if n_frames < 1:
        raise ValueError("corrupt LOPC chain (empty frame index)")
    if n_tiles != int(np.prod(grid)):
        raise ValueError("corrupt LOPC container (tile count/grid mismatch)")
    extra = {}
    for _ in range(n_extra):
        tag, off, n = r.unpack("BQQ")
        if tag not in V3_KNOWN_TAGS:
            raise ValueError(f"unknown v3 section tag {tag}")
        extra[tag] = (off, n)
    entries = [FrameEntry(*r.unpack(_FRAME_ENTRY_FMT)) for _ in range(n_frames)]
    head_crc_expected = zlib.crc32(blob[: r.off]) & 0xFFFFFFFF
    if r.unpack("I") != head_crc_expected:
        raise ValueError("corrupt LOPC container (index crc mismatch)")
    data_off = r.off
    for e in entries:
        if e.kind not in (FRAME_KEY, FRAME_RESIDUAL):
            raise ValueError(f"corrupt LOPC chain (frame kind {e.kind})")
    if entries[0].kind != FRAME_KEY:
        raise ValueError("corrupt LOPC chain (frame 0 is not a keyframe)")
    end = max(
        [e.off + e.length for e in entries]
        + [off + n for off, n in extra.values()]
    )
    if data_off + end > len(blob):
        raise ValueError("truncated stream")
    header = Header(CODES_DTYPE[dtc], shape, eb_mode, eb, eps_abs, flags)
    return ContainerV3(header, tile_shape, grid, keyframe_interval, entries,
                       extra, data_off, blob)
