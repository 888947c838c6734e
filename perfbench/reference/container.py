"""Plain reader of a tiled (version 2) LOPC container, written from the
container's byte-level description alone (the format's normative text).

``read(blob, device)`` checks the head and every tile's crc32, undoes
each section's byte stage, repeat elimination, zero-word elimination,
bit-plane transpose and integer transform, and returns the field's bins
and subbins as int64 tensors with the header.  Sections are parsed on
the host one by one; the word arithmetic runs on ``device`` over all
tiles at once.  Any departure from the format raises ``ValueError``.

Nothing here imports the program under test.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .lopc import EPS_SHRINK, dequantize

MAGIC = b"LOPC"
DTYPES = {0: torch.float32, 1: torch.float64}
MODES = {0: "abs", 1: "noa"}
KNOWN_TAGS = (3, 4)
CHUNK_WORDS = {2: 8192, 4: 4096, 8: 2048}


class _Reader:
    def __init__(self, buf: bytes, off: int = 0):
        self.buf, self.off = buf, off

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("truncated")
        self.off += n
        return b

    def unpack(self, fmt: str):
        v = struct.unpack("<" + fmt, self.raw(struct.calcsize("<" + fmt)))
        return v if len(v) > 1 else v[0]

    def lp(self) -> bytes:
        return self.raw(self.unpack("Q"))


def head(blob: bytes) -> dict:
    """Header, tile geometry and tile index of a version-2 container."""
    r = _Reader(blob)
    if r.raw(4) != MAGIC:
        raise ValueError("bad magic")
    version, flags, dtc, ndim = r.unpack("BBBB")
    if version != 2 or dtc not in DTYPES or not 1 <= ndim <= 3:
        raise ValueError("bad version, dtype or rank")
    shape = struct.unpack("<" + "Q" * ndim, r.raw(8 * ndim))
    mode = r.unpack("B")
    eb, eps_abs = r.unpack("dd")
    tile = r.unpack("QQQ")
    grid = r.unpack("QQQ")
    n_tiles, n_extra = r.unpack("IB")
    extra = {}
    for _ in range(n_extra):
        tag, off, n = r.unpack("BQQ")
        if tag not in KNOWN_TAGS:
            raise ValueError("unknown section tag")
        extra[tag] = (off, n)
    index = np.frombuffer(r.raw(36 * n_tiles), np.dtype([
        ("bins_off", "<u8"), ("bins_len", "<u8"), ("sub_off", "<u8"),
        ("sub_len", "<u8"), ("crc", "<u4")]))
    crc = zlib.crc32(blob[:r.off])
    if r.unpack("I") != crc:
        raise ValueError("head crc")
    if mode not in MODES or n_tiles != grid[0] * grid[1] * grid[2]:
        raise ValueError("bad mode or tile count")
    return {"flags": flags, "dtype": DTYPES[dtc], "shape": tuple(shape),
            "mode": MODES[mode], "eb": eb, "eps_abs": eps_abs,
            "tile": tuple(tile), "grid": tuple(grid), "extra": extra,
            "index": index, "data_off": r.off}


def _section(buf: bytes):
    """One RZE section -> (n_chunks, word bytes, bitmap bytes big-endian
    per word, nonzero data words as raw bytes)."""
    r = _Reader(buf)
    n_chunks, chunk_len, word, final = r.unpack("IIBB")
    if word not in CHUNK_WORDS or chunk_len != CHUNK_WORDS[word] or final > 1:
        raise ValueError("bad section header")
    payload = buf[r.off:]
    if final:
        p = _Reader(payload)
        n = p.unpack("Q")
        keep = np.unpackbits(np.frombuffer(p.lp(), np.uint8), count=n).astype(bool)
        nz = np.frombuffer(payload[p.off:], np.uint8)
        if int(keep.sum()) != nz.size:
            raise ValueError("byte stage length")
        inner = np.zeros(n, np.uint8)
        inner[keep] = nz
        payload = inner.tobytes()
    p = _Reader(payload)
    keepmap, kept, data = p.lp(), p.lp(), p.lp()
    if p.off != len(payload):
        raise ValueError("trailing bytes")
    n_words = n_chunks * chunk_len // (8 * word)
    keep = np.unpackbits(np.frombuffer(keepmap, np.uint8), count=n_words).astype(bool)
    kept = np.frombuffer(kept, f"<u{word}")
    if n_words and (not keep[0] or int(keep.sum()) != kept.size):
        raise ValueError("bitmap repeat elimination")
    bitmap = kept[np.cumsum(keep) - 1] if n_words else kept[:0]
    return n_chunks, word, bitmap.astype(f">u{word}").tobytes(), data


def _words(sections, cpt: int, word: int, device) -> torch.Tensor:
    """All tiles' chunk rows of one stream, zero words restored and the
    bit planes untransposed -> (n_tiles * cpt, chunk_len) int64 holding
    the stored words' bits."""
    L = CHUNK_WORDS[word]
    w = 8 * word
    n_tiles = len(sections)
    rows, bitmaps, datas = [], [], []
    for t, (n_chunks, wb, bitmap, data) in enumerate(sections):
        if n_chunks > cpt or (n_chunks and wb != word):
            raise ValueError("section rows or width")
        rows.extend(range(t * cpt, t * cpt + n_chunks))
        bitmaps.append(bitmap)
        datas.append(data)
    mask = np.zeros((n_tiles * cpt, L), bool)
    mask[rows] = np.unpackbits(
        np.frombuffer(b"".join(bitmaps), np.uint8)).reshape(len(rows), L).astype(bool)
    data = np.frombuffer(b"".join(datas), f"<u{word}")
    if int(mask.sum()) != data.size:
        raise ValueError("zero-word elimination length")
    host = np.zeros((n_tiles * cpt, L), f"<u{word}")
    host[mask] = data
    # a torch tensor of the words' bit patterns, in a signed type wide
    # enough that shifts and masks act on the unsigned value
    src = torch.from_numpy(host.view(f"<i{word}").astype(np.int64)).to(device)
    if word < 8:
        src &= (1 << w) - 1
    # plane b holds bit (w - 1 - b) of every word, MSB first
    planes = src.view(-1, w, L // w)
    out = torch.zeros_like(src).view(-1, L // w, w)
    for b in range(w):
        p = planes[:, b, :]
        for i in range(w):
            bit = (p >> (w - 1 - i)) & 1
            out[:, :, i] |= bit << (w - 1 - b)
    return out.view(-1, L)


def _signed(v: torch.Tensor, w: int) -> torch.Tensor:
    """Read the low ``w`` bits of ``v`` as a two's-complement integer."""
    if w == 64:
        return v
    v = v & ((1 << w) - 1)
    return torch.where(v >= 1 << (w - 1), v - (1 << w), v)


def _stream(sections, cpt, tile_elems, delta: bool, device) -> torch.Tensor:
    """(n_tiles, tile_elems) int64 values of one stream."""
    widths = {s[1] for s in sections if s[0]}
    if len(widths) > 1:
        raise ValueError("mixed section widths")
    word = widths.pop() if widths else 2
    w = 8 * word
    v = _words(sections, cpt, word, device)
    if delta:
        # zigzag inverse, then a running sum per chunk in the stored width
        v = _signed((v >> 1) & ((1 << (w - 1)) - 1), w) ^ -(v & 1)
        v = _signed(torch.cumsum(v, dim=1), w)
    else:
        v = _signed(v, w)
    return v.reshape(len(sections), cpt * CHUNK_WORDS[word])[:, :tile_elems]


def read(blob: bytes, device="cpu") -> dict:
    """Bins and subbins of a version-2 container, placed in the field.

    Returns the head's fields plus ``bins`` and ``subbins`` (int64
    tensors of the field's shape on ``device``; subbins are zero where the
    container keeps no order)."""
    h = head(blob)
    if h["extra"]:
        raise ValueError("sidecar sections are not read here")
    data = memoryview(blob)[h["data_off"]:]
    tile, grid = h["tile"], h["grid"]
    tile_elems = tile[0] * tile[1] * tile[2]
    order = bool(h["flags"] & 1)
    bins_s, subs_s = [], []
    for e in h["index"]:
        b = bytes(data[e["bins_off"]:e["bins_off"] + e["bins_len"]])
        s = bytes(data[e["sub_off"]:e["sub_off"] + e["sub_len"]])
        if len(b) != e["bins_len"] or len(s) != e["sub_len"]:
            raise ValueError("truncated tile")
        if zlib.crc32(s, zlib.crc32(b)) != e["crc"]:
            raise ValueError("tile crc")
        if not b or bool(s) != order:
            raise ValueError("missing section")
        bins_s.append(_section(b))
        if order:
            subs_s.append(_section(s))
    out = dict(h)

    def place(sections, delta):
        word = next((s[1] for s in sections if s[0]), 2)
        cpt = -(-tile_elems // CHUNK_WORDS[word])
        t = _stream(sections, cpt, tile_elems, delta, device)
        f = t.view(*grid, *tile).permute(0, 3, 1, 4, 2, 5).reshape(
            grid[0] * tile[0], grid[1] * tile[1], grid[2] * tile[2])
        canon = (1,) * (3 - len(h["shape"])) + h["shape"]
        return f[:canon[0], :canon[1], :canon[2]].reshape(h["shape"])

    out["bins"] = place(bins_s, True)
    out["subbins"] = (place(subs_s, False) if order
                      else torch.zeros_like(out["bins"]))
    return out


def values(c: dict) -> torch.Tensor:
    """A read container's cell values by the format's value rule."""
    return dequantize(c["bins"], c["subbins"], c["eps_abs"] * EPS_SHRINK,
                      c["dtype"])
