"""A numpy model of how the fused decode (kernels 3 and 3') and encode
(kernel 2) divide their work, held on the CPU to the port's plain
versions.

The decode kernel gives one CTA one bins chunk row of one tile and the
subbin plane words of the same elements: one subbin row at equal widths,
the 2 or 4 rows of a wider subbin word, the part of a row (a range of
plane-word columns q) of a narrower one.  ``partition`` repeats the
kernel's index arithmetic (``fused_decode.cu``: ``work``, ``r0``/``nsr``,
``qa``, ``LG_NQ``); ``model_decode`` decodes every CTA's share as the
kernel does (the popcount prefix of the bitmap rows in 16-bit units, the
expand into a staging buffer with padded planes, the shuffle butterfly
of ``lane_transpose.cuh`` emulated over 32 lanes, the warp-unit element
order) and finishes each value with the plain version's pieces.  The
encode model transposes each thread's 32 words in registers (16- and
32-bit words) or stages the butterfly's planes (64-bit), as
``fused_encode.cu`` does.  The BIT_4 transpose (kernel 8) is modelled by
thread (one per plane-word column, ``transpose32``, the inverse's padded
shared stage), and the value encode (kernel 4) by its per-cell op
sequence (``model_quantize``: the reciprocal quotient, rounding by
1.5 * 2^52, the first pass's bases compared in f64, the fallback to the
reference's sequence) and its predecessor exchange.  No jax and no
reference: the plain versions are held to the reference elsewhere
(tests/test_torch_kernels.py, tests/test_torch_ops.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.floatbits import float_to_ordered, int_dtype_for, ordered_to_float
from repro_torch.core.quantize import decode_base, quantize_broadcast
from repro_torch.kernels import fused_decode as pt_fd
from repro_torch.kernels import fused_encode as pt_fe
from repro_torch.kernels import ref as pt_ref

WIDTHS = (16, 32, 64)
UNSIGNED = {16: np.uint16, 32: np.uint32, 64: np.uint64}
SIGNED = {16: np.int16, 32: np.int32, 64: np.int64}
# the 3-D (16x16x64), 2-D (64x64) and 1-D (4096) plan tiles' cells, and
# an odd count
TILES = {"3-D": 16384, "2-D": 64 * 64, "1-D": 4096, "odd": 8192 + 100}
LANE = np.arange(32)


def geometry(w: int) -> dict:
    length = 131072 // w
    p = length // w
    return {"L": length, "P": p, "G": 64 if w == 64 else 32,
            "STRIDE": p + (2 if w == 16 else 1)}


def partition(batch: int, elems: int, bw: int, sw: int | None) -> list:
    """The CTAs of one launch, in grid order: each CTA's tile, bins chunk
    row, elements [e0, e0 + ne), and subbin rows (row, first plane-word
    column qa, columns nq)."""
    bl = geometry(bw)["L"]
    nbc = -(-elems // bl)
    ctas = []
    for block in range(batch * nbc):
        tile, c = divmod(block, nbc)
        e0 = c * bl
        ne = min(bl, elems - e0)
        cta = {"tile": tile, "c": c, "e0": e0, "ne": ne, "sub": []}
        if sw is not None:
            sl, ps = geometry(sw)["L"], geometry(sw)["P"]
            r0 = e0 // sl
            nsr = (e0 + ne - 1) // sl - r0 + 1
            nq = bl // sw if sw < bw else ps
            for r in range(r0, r0 + nsr):
                qa = max(e0 - r * sl, 0) // sw
                cta["sub"].append((r, qa, nq))
        ctas.append(cta)
    return ctas


def butterfly(x: np.ndarray, w: int) -> np.ndarray:
    """``transpose_stages`` of lane_transpose.cuh over the last axis (32
    lanes); 16-bit words sit in the low half of uint32."""
    x = x.copy()
    bits = x.dtype.itemsize * 8
    for j in ((8, 4, 2, 1) if w == 16 else (16, 8, 4, 2, 1)):
        hi32 = {16: 0xFFFF0000, 8: 0xFF00FF00, 4: 0xF0F0F0F0, 2: 0xCCCCCCCC,
                1: 0xAAAAAAAA}[j]
        hi = x.dtype.type(hi32 | (hi32 << 32) if bits == 64 else hi32)
        y = x[..., LANE ^ j]
        lower = (LANE & j) != 0
        moved = np.where(lower, y << x.dtype.type(j), y >> x.dtype.type(j))
        keep = np.where(lower, ~hi, hi).astype(x.dtype)
        x = (x & keep) | (moved & ~keep)
    return x


def butterfly64(x0: np.ndarray, x1: np.ndarray):
    """``transpose_lanes64``: rows lane (x0) and lane + 32 (x1)."""
    lo = np.uint64(0xFFFFFFFF)
    a = (x0 & ~lo) | (x1 >> np.uint64(32))
    b = (x1 & lo) | (x0 << np.uint64(32))
    return butterfly(a, 64), butterfly(b, 64)


def untranspose(stage: np.ndarray, w: int, u: int) -> list:
    """The kernel's ``untranspose`` of unit u: one array of 32 lanes per
    32 elements of the unit, in element order."""
    s = geometry(w)["STRIDE"]
    if w == 16:
        x = butterfly(stage[(LANE & 15) * s + 2 * u + (LANE >> 4)]
                      .astype(np.uint32), 16)
        assert not (x >> np.uint32(16)).any(), "bits above the 16-bit word"
        return [x]
    if w == 32:
        return [butterfly(stage[LANE * s + u], 32)]
    return list(butterfly64(stage[LANE * s + u], stage[(LANE + 32) * s + u]))


def prefix16(bitmaps: list) -> np.ndarray:
    """Exclusive popcount prefix over the 16-bit units of the bitmap rows
    laid end to end, one more entry for the total."""
    units = np.concatenate([b.view(np.uint16) for b in bitmaps])
    counts = np.unpackbits(units.view(np.uint8)).reshape(-1, 16).sum(1)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _popcount(x: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(x.astype(np.uint64).view(np.uint8))
    return bits.reshape(-1, 64).sum(1).astype(np.int64)


def expand(bm: np.ndarray, pre: np.ndarray, pk: np.ndarray, w: int, qa: int,
           nq: int) -> np.ndarray:
    """The kernel's ``expand`` of plane words (p, qa + qq) into a staging
    buffer of padded planes."""
    g = geometry(w)
    stage = np.zeros(w * g["STRIDE"], dtype=UNSIGNED[w])
    p, qq = np.divmod(np.arange(w * nq), nq)
    m, r = np.divmod(p * g["P"] + qa + qq, w)
    word = bm[m].astype(np.uint64)
    bit = (word >> (w - 1 - r).astype(np.uint64)) & np.uint64(1)
    above = np.where(r > 0, _popcount(word >> np.where(r > 0, w - r, 0)
                                      .astype(np.uint64)), 0)
    idx = np.where(bit == 1, pre[m * (w // 16)] - pre[0] + above, 0)
    stage[p * g["STRIDE"] + qq] = np.where(bit == 1, pk[idx], 0)
    return stage


def transpose16x2(x: np.ndarray) -> np.ndarray:
    """``transpose16x2`` of lane_transpose.cuh: x (16, threads) uint32,
    row r of two 16 x 16 matrices in the low and high halves."""
    x = x.copy()
    for j, lo in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                  (1, 0x55555555)):
        for r in range(16):
            if r & j:
                continue
            t = ((x[r + j] >> np.uint32(j)) ^ x[r]) & np.uint32(lo)
            x[r] ^= t
            x[r + j] ^= t << np.uint32(j)
    return x


def transpose32(x: np.ndarray) -> np.ndarray:
    """``transpose32`` of lane_transpose.cuh: x (32, threads) uint32."""
    x = x.copy()
    for j, lo in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                  (2, 0x33333333), (1, 0x55555555)):
        for r in range(32):
            if r & j:
                continue
            t = ((x[r + j] >> np.uint32(j)) ^ x[r]) & np.uint32(lo)
            x[r] ^= t
            x[r + j] ^= t << np.uint32(j)
    return x


def gather16(bm: np.ndarray, pre: np.ndarray, pk: np.ndarray) -> np.ndarray:
    """``gather16`` of fused_decode.cu for threads 0..255 of a 16-bit row:
    the words of the row in order."""
    t = np.arange(256)
    r = (2 * t) & 15
    y = np.zeros((16, 256), dtype=np.uint32)
    for p in range(16):
        m = p * 32 + (t >> 3)
        word = bm[m].astype(np.uint32)
        above = np.where(r > 0, _popcount(word >> np.where(r > 0, 16 - r, 0)
                                          .astype(np.uint32)), 0)
        idx = pre[m] - pre[0] + above
        b0 = (word >> (15 - r).astype(np.uint32)) & 1
        b1 = (word >> (14 - r).astype(np.uint32)) & 1
        v0 = np.where(b0 == 1, pk[np.where(b0 == 1, idx, 0)], 0).astype(np.uint32)
        v1 = np.where(b1 == 1, pk[np.where(b1 == 1, idx + b0, 0)], 0).astype(np.uint32)
        y[p] = v0 | (v1 << np.uint32(16))
    y = transpose16x2(y)
    # thread t: words 32t + r (low halves), 32t + 16 + r (high halves)
    words = np.concatenate([y & np.uint32(0xFFFF), y >> np.uint32(16)])
    return words.T.reshape(-1)


def _signed(v: np.ndarray, w: int) -> np.ndarray:
    """w-bit unsigned words (in a wider unsigned array) as signed int64."""
    v = v.astype(np.uint64)
    if w == 64:
        return v.view(np.int64)
    s = v.astype(np.int64)
    return np.where(s >= 1 << (w - 1), s - (1 << w), s)


def model_decode(bitmap, packed, sub_bitmap, sub_packed, eps, elems: int,
                 dtype: torch.dtype):
    """Every CTA's share of the decode, as the kernel computes it; the
    decode base and the ordered add are the plain version's."""
    bw = bitmap.dtype.itemsize * 8
    sw = None if sub_bitmap is None else sub_bitmap.dtype.itemsize * 8
    batch = eps.shape[0]
    bcpt = bitmap.shape[0] // batch
    scpt = 0 if sw is None else sub_bitmap.shape[0] // batch
    bins = np.zeros((batch, elems), dtype=np.int64)
    subs = np.zeros((batch, elems), dtype=np.int64)
    seen_bins = np.zeros((batch, elems), dtype=np.int64)
    seen_subs = np.zeros((batch, elems), dtype=np.int64)
    gb = geometry(bw)
    mask = (1 << bw) - 1
    for cta in partition(batch, elems, bw, sw):
        t, e0, ne = cta["tile"], cta["e0"], cta["ne"]
        brow = t * bcpt + cta["c"]
        rows = [(s, sub_bitmap[t * scpt + r].view(UNSIGNED[sw]),
                 sub_packed[t * scpt + r].view(UNSIGNED[sw]))
                for s, (r, _, _) in enumerate(cta["sub"])]
        bbm = bitmap[brow].view(UNSIGNED[bw])
        pre = prefix16([bbm] + [bm for _, bm, _ in rows])
        if bw == 16:  # registers, thread t on words 32t .. 32t + 31
            z = gather16(bbm, pre, packed[brow].view(np.uint16)).astype(np.uint64)
        else:  # staged, then lanes, units in order
            stage = expand(bbm, pre, packed[brow].view(UNSIGNED[bw]), bw, 0,
                           gb["P"])
            z = np.concatenate([x.astype(np.uint64)
                                for u in range(gb["L"] // gb["G"])
                                for x in untranspose(stage, bw, u)])
        d = (z >> np.uint64(1)) ^ (np.uint64(0) - (z & np.uint64(1)))
        run = np.cumsum(d, dtype=np.uint64) & np.uint64(mask)
        bins[t, e0: e0 + ne] = _signed(run[:ne], bw)
        seen_bins[t, e0: e0 + ne] += 1
        units_b = gb["P"] * bw // 16
        for s, bm, pk in rows:
            r, qa, nq = cta["sub"][s]
            gs = geometry(sw)
            u16 = units_b + s * gs["P"] * sw // 16
            if bw == sw == 16:
                e = np.arange(gs["L"]) + r * gs["L"]
                subs[t, e0: e0 + ne] = _signed(gather16(bm, pre[u16:], pk), 16)[:ne]
                seen_subs[t, e0: e0 + ne] += 1
                assert (e[:ne] == np.arange(e0, e0 + ne)).all()
                continue
            stage = expand(bm, pre[u16:], pk, sw, qa, nq)
            for u in range(sw * nq // gs["G"]):
                for h, x in enumerate(untranspose(stage, sw, u)):
                    e = r * gs["L"] + qa * sw + u * gs["G"] + 32 * h + LANE
                    keep = (e >= e0) & (e < e0 + ne)
                    sub = _signed(x[keep], sw)
                    subs[t, e[keep]] = sub
                    seen_subs[t, e[keep]] += 1
    assert (seen_bins == 1).all(), "a bins element decoded not exactly once"
    if sw is not None:
        assert (seen_subs == 1).all(), "a subbin element decoded not exactly once"
    base = decode_base(torch.from_numpy(bins), torch.from_numpy(eps)[:, None],
                       dtype)
    o = float_to_ordered(base).to(torch.int64) + torch.from_numpy(subs)
    return ordered_to_float(o.to(int_dtype_for(dtype)), dtype)


def _pack(rows: np.ndarray) -> np.ndarray:
    out = np.zeros_like(rows)
    for r in range(rows.shape[0]):
        nz = rows[r][rows[r] != 0]
        out[r, : nz.size] = nz
    return out


def _stream(ints: np.ndarray, transform: str):
    w = ints.dtype.itemsize * 8
    bm, words, _ = pt_fe.encode_ints_plain(torch.from_numpy(ints),
                                           131072 // w, transform)
    return bm.numpy(), _pack(words.numpy())


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("bw,sw", [(b, s) for b in WIDTHS for s in WIDTHS])
def test_decode_partition_covers_each_element_once(tile, bw, sw):
    elems = TILES[tile]
    for batch in (1, 3):
        ctas = partition(batch, elems, bw, sw)
        bins = np.zeros((batch, elems), np.int64)
        subs = np.zeros((batch, elems), np.int64)
        for cta in ctas:
            bins[cta["tile"], cta["e0"]: cta["e0"] + cta["ne"]] += 1
            sl = geometry(sw)["L"]
            for r, qa, nq in cta["sub"]:
                lo = max(r * sl + qa * sw, cta["e0"])
                hi = min(r * sl + (qa + nq) * sw, cta["e0"] + cta["ne"], elems)
                subs[cta["tile"], lo:hi] += 1
                assert r < -(-elems // sl), "a subbin row past the tile"
                assert qa + nq <= geometry(sw)["P"]
            # the rows a CTA touches: one at most unless the subbin word
            # is wider, then at most SW / BW
            assert len(cta["sub"]) <= max(1, sw // bw)
        assert (bins == 1).all() and (subs == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bw,sw", [(b, s) for b in WIDTHS for s in WIDTHS]
                         + [(b, None) for b in WIDTHS])
def test_decode_model_equals_plain(rng, bw, sw, dtype):
    tile = "odd" if (bw + (sw or 0)) % 3 else ("1-D" if bw == 64 else "3-D")
    elems, batch = TILES[tile], 2
    info = np.iinfo(SIGNED[bw])
    bins = np.cumsum(rng.integers(-3, 4, (batch, elems)), axis=1)
    bins = (bins + rng.integers(-2**14, 2**14, (batch, 1))).astype(SIGNED[bw])
    bins[0, 5:900] = 0                          # sparse rows
    bins[1, 1::11] = info.min                   # wrapping deltas
    bins[1, 2::13] = info.max
    streams = list(_stream(bins, "delta"))
    if sw is None:
        streams += [None, None]
    else:
        subs = rng.integers(0, 9, (batch, elems)).astype(SIGNED[sw])
        subs[0, : elems // 2] = 0
        streams += list(_stream(subs, "raw"))
    eps = np.array([1e-3, 0.7]) if dtype == torch.float32 else np.array([3e-9, 2.0])
    want = pt_fd.decode_tiles_plain(
        *[None if a is None else torch.from_numpy(a) for a in streams],
        torch.from_numpy(eps), elems, dtype)
    got = model_decode(*streams, eps, elems, dtype)
    idt = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got.view(idt), want.view(idt))


def model_encode(ints: np.ndarray, transform: str):
    """The encode kernel's staging, copy-out and bitmap, per chunk row."""
    w = ints.dtype.itemsize * 8
    g = geometry(w)
    length, p, s = g["L"], g["P"], g["STRIDE"]
    u = UNSIGNED[w]
    batch, elems = ints.shape
    cpt = -(-elems // length)
    padded = np.zeros((batch, cpt * length), dtype=ints.dtype)
    padded[:, :elems] = ints
    rows = padded.reshape(-1, length).view(u)
    bitmaps, words, counts = [], [], []
    for row in rows:
        d = row.copy()
        if transform == "delta":
            d[1:] = row[1:] - row[:-1]
        if transform != "raw":  # the zigzag: after the delta, or alone
            sign = (d.view(SIGNED[w]) < 0).astype(u) * u(~u(0))
            d = (d << u(1)) ^ sign
        if w == 16:  # thread t: words 32t .. 32t + 31, two halves a register
            x = d.reshape(256, 16, 2).astype(np.uint32)
            x = (x[..., 0] | (x[..., 1] << np.uint32(16))).T     # (16, 256)
            y = np.stack([np.where(r & 1, (x[r // 2] >> np.uint32(16))
                                   | (x[8 + r // 2] & np.uint32(0xFFFF0000)),
                                   (x[r // 2] & np.uint32(0xFFFF))
                                   | (x[8 + r // 2] << np.uint32(16)))
                          for r in range(16)])
            y = transpose16x2(y)                                 # y[p, t]
            out = np.stack([y & np.uint32(0xFFFF), y >> np.uint32(16)], -1)
            out = out.reshape(-1).astype(u)                      # (p, t, half)
            b = (out != 0).reshape(16, 8, 4, 8, 2)   # p, warp, lane // 8, ...
            flags = b.reshape(16, 32, 16)            # bitmap word p*32 + 4w + k
            bm = np.array([int("".join("1" if f else "0" for f in row), 2)
                           for row in flags.reshape(-1, 16)], dtype=u)
            bitmaps.append(bm)
            words.append(out)
            counts.append(int((out != 0).sum()))
            continue
        if w == 32:  # thread t: words 32t .. 32t + 31, one column a plane
            y = transpose32(d.reshape(128, 32).T)               # y[p, t]
            out = y.reshape(-1)
            nz = (out != 0).reshape(p, w)
            bitmaps.append(np.array([int("".join("1" if f else "0" for f in r),
                                         2) for r in nz], dtype=u))
            words.append(out)
            counts.append(int((out != 0).sum()))
            continue
        stage = np.zeros(w * s, dtype=u)
        for unit in range(length // g["G"]):
            lanes = d[unit * g["G"]: (unit + 1) * g["G"]]
            if w == 16:
                x = butterfly(lanes.astype(np.uint32), 16)
                stage[(LANE & 15) * s + 2 * unit + (LANE >> 4)] = x.astype(u)
            elif w == 32:
                stage[LANE * s + unit] = butterfly(lanes, 32)
            else:
                x0, x1 = butterfly64(lanes[:32], lanes[32:])
                stage[LANE * s + unit] = x0
                stage[(LANE + 32) * s + unit] = x1
        out = np.array([stage[(j // p) * s + j % p] for j in range(length)],
                       dtype=u)
        bm = np.zeros(p, dtype=u)
        if w == 16:  # two words a lane, ballots b0 (even) and b1 (odd)
            for pas in range(length // 64):
                pair = out[pas * 64: (pas + 1) * 64]
                b0 = sum(int(pair[2 * i] != 0) << i for i in range(32))
                b1 = sum(int(pair[2 * i + 1] != 0) << i for i in range(32))
                for lane in range(4):
                    z = 0
                    for i in range(8):
                        z |= ((b0 >> (8 * lane + i)) & 1) << (2 * i)
                        z |= ((b1 >> (8 * lane + i)) & 1) << (2 * i + 1)
                    bm[4 * pas + lane] = int(f"{z:016b}"[::-1], 2)
        else:
            nz = (out != 0).reshape(p, w)
            for m in range(p):
                bm[m] = int("".join("1" if f else "0" for f in nz[m]), 2)
        bitmaps.append(bm)
        words.append(out)
        counts.append(int((out != 0).sum()))
    return (np.stack(bitmaps).view(SIGNED[w]), np.stack(words).view(SIGNED[w]),
            np.array(counts, dtype=np.int32))


@pytest.mark.parametrize("transform", ["delta", "raw", "zigzag"])
@pytest.mark.parametrize("w", WIDTHS)
def test_encode_model_equals_plain(rng, w, transform):
    elems = geometry(w)["L"] + 37
    info = np.iinfo(SIGNED[w])
    ints = rng.integers(-50, 50, (2, elems)).astype(SIGNED[w])
    ints[0, :300] = 0
    ints[1, ::5] = info.min
    ints[1, 1::7] = info.max
    got = model_encode(ints, transform)
    want = pt_fe.encode_ints_plain(torch.from_numpy(ints), 131072 // w,
                                   transform)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())


# ---- the BIT_4 transpose (kernel 8): thread g of a chunk's 128 owns
# plane-word column g, words 32g .. 32g + 31

ROW = 36  # the inverse's padded shared row, words


def model_bitshuffle(words: np.ndarray) -> np.ndarray:
    """(C, 4096) uint32 -> planes: thread g loads words 32g .. 32g + 31
    (x[r] = word 32g + r), transposes, stores plane p's word g at
    128p + g."""
    out = np.empty_like(words)
    for c, chunk in enumerate(words):
        y = transpose32(chunk.reshape(128, 32).T)  # y[p, g]
        for p in range(32):
            out[c, 128 * p + np.arange(128)] = y[p]
    return out


def model_bitunshuffle(planes: np.ndarray) -> np.ndarray:
    """Inverse: thread g loads in[128p + g] for p = 0..31, transposes
    (x[i] = word 32g + i), writes its row of the shared stage (ROW words
    a thread, 16 bytes at a time), then the CTA copies the chunk out, 16
    bytes a thread: unit j from row j >> 3, words 4 (j & 7) onward."""
    out = np.empty_like(planes)
    for c, chunk in enumerate(planes):
        x = np.stack([chunk[128 * p + np.arange(128)] for p in range(32)])
        y = transpose32(x)  # y[i, g]
        sh = np.zeros(128 * ROW, dtype=np.uint32)
        for g in range(128):
            sh[g * ROW: g * ROW + 32] = y[:, g]
        units = np.arange(1024)
        for k in range(4):
            out[c, 4 * units + k] = sh[(units >> 3) * ROW + 4 * (units & 7) + k]
    return out


def test_bitshuffle_stage_rows_are_conflict_free():
    """Eight consecutive threads' 16-byte stores to the padded rows, and
    eight consecutive units' 16-byte reads, fall in distinct groups of
    four banks."""
    for i in range(8):
        banks = {((g * ROW + 4 * i) % 32) // 4 for g in range(8)}
        assert len(banks) == 8
    for j0 in range(0, 1024, 8):
        j = np.arange(j0, j0 + 8)
        assert len(set(((j >> 3) * ROW + 4 * (j & 7)) % 32 // 4)) == 8


def bit4_words(rng, chunks: int) -> np.ndarray:
    """Random words, then the adversarial ones in turn: all zero, all
    ones, one set bit at each of the 32 positions, 0x80000000,
    alternating bytes."""
    w = rng.integers(0, 2**32, (chunks, 4096), dtype=np.uint64).astype(np.uint32)
    special = np.concatenate([
        np.zeros(64, np.uint32), np.full(64, 0xFFFFFFFF, np.uint32),
        np.uint32(1) << np.arange(32, dtype=np.uint32),
        np.full(32, 0x80000000, np.uint32),
        np.resize(np.array([0xFF00FF00, 0x00FF00FF], np.uint32), 64)])
    flat = w.reshape(-1)
    flat[: special.size] = special
    flat[-special.size:] = special[::-1]
    return w


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_bitshuffle_model_equals_plain(rng, chunks):
    words = bit4_words(rng, chunks)
    t = torch.from_numpy(words.view(np.int32))
    shuffled = model_bitshuffle(words)
    assert np.array_equal(shuffled.view(np.int32), pt_ref.bitshuffle_ref(t).numpy())
    back = model_bitunshuffle(shuffled)
    want = pt_ref.bitunshuffle_ref(torch.from_numpy(shuffled.view(np.int32)))
    assert np.array_equal(back.view(np.int32), want.numpy())
    assert np.array_equal(back, words)


# ---- the value encode (kernel 4): the per-cell op sequence

KROUND = 1.5 * 2.0**52
F32_TINY = float(np.finfo(np.float32).tiny)


def model_quantize(x: np.ndarray, eps: float):
    """Kernel 4's bins of f32 cells on a tile of bin width ``eps``, and
    which cells its fast path took: ``quantize_fast`` (q = x * rcp on the
    cell as it is, subnormal or not, rint by adding and subtracting
    1.5 * 2^52), vouched for where |q| < 2^30 and q lies more than 2^-20
    from every half-integer; the other finite cells, and every cell of a
    tile without the fast path (eps below 2 * FLT_MIN or above 2^1000),
    take the reference's sequence (``quantize_f32``, modelled by the
    plain ``quantize_broadcast``); non-finite cells take bin 0."""
    x = np.asarray(x, np.float32)
    fin = np.isfinite(x)
    tile_fast = 2 * F32_TINY <= eps <= 2.0**1000
    with np.errstate(over="ignore", invalid="ignore"):
        rcp = np.float64(1.0) / np.float64(eps)
        q = x.astype(np.float64) * rcp
        s = q + KROUND
        r = s - KROUND
        b = (s.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ok = (np.abs(q) < 2.0**30) & (np.abs(q - r) < 0.5 - 2.0**-20)
    fast = ok & tile_fast
    slow = fin & ~fast
    ref = quantize_broadcast(torch.from_numpy(np.where(slow, x, 0)), eps,
                             torch.float32).numpy()
    bins = np.where(fast, b.view(np.int32), np.where(slow, ref, 0))
    return bins.astype(np.int32), fast


def adversarial_cells(rng, eps: float) -> np.ndarray:
    """f32 cells for a tile of width eps: cells at (k +- 0.5) eps and 1
    and 2 f32 ulps either side, the exact bases (decode_base) and one ulp
    below, +-0, subnormals, non-finite cells, |q| near 2^30 and near 2^31
    (inside int32), and a random spread."""
    k = rng.integers(-2000, 2000, 400).astype(np.float64)
    halves = np.concatenate([(k + 0.5) * eps, (k - 0.5) * eps]).astype(np.float32)
    near = [halves]
    for steps in (1, 2):
        near += [np.nextafter(halves, np.float32(np.inf)), np.nextafter(
            halves, np.float32(-np.inf))]
        for _ in range(steps - 1):
            near[-2] = np.nextafter(near[-2], np.float32(np.inf))
            near[-1] = np.nextafter(near[-1], np.float32(-np.inf))
    bases = decode_base(torch.from_numpy(k.astype(np.int32)), eps,
                        torch.float32).numpy()
    big = []
    for top in (2.0**30, 2.0**31 - 256):
        qs = top + np.arange(-3, 3) * 37.0
        big += [(qs * eps).astype(np.float32), (-qs * eps).astype(np.float32)]
    big = np.concatenate(big)
    big = big[np.abs(big.astype(np.float64) / eps) < 2.0**31 - 2]
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-41, -1e-41,
                        F32_TINY, -F32_TINY], np.float32)
    subnormal = np.nextafter(np.float32(F32_TINY), np.float32(0)) * np.array(
        [1, -1], np.float32)  # the largest subnormals: |q| near 1/2 at 2 tiny
    spread = (rng.standard_normal(2000) * 300 * eps).astype(np.float32)
    return np.concatenate(near + [bases, np.nextafter(bases, np.float32(-np.inf)),
                                  big, special, subnormal, spread])


def test_quantize_model_equals_plain(rng):
    """The fast path with its fallback gives the plain ``quantize_broadcast``
    bit for bit, over eps 1e-6 .. 1 and bounds within 2x of the smallest
    normal; the fast path takes most cells and leaves the cells at
    half-integer quotients and |q| >= 2^30 to the fallback."""
    epss = list(np.geomspace(1e-6, 1.0, 13)) + [
        float(rng.uniform(1e-6, 1.0)), 0.1, 2.0**-10, 1.5 * F32_TINY,
        2 * F32_TINY, 4 * F32_TINY]
    taken = []
    for eps in epss:
        x = adversarial_cells(rng, eps)
        got, fast = model_quantize(x, eps)
        want = quantize_broadcast(torch.from_numpy(x), eps, torch.float32)
        want = torch.where(torch.isfinite(torch.from_numpy(x)), want, 0).numpy()
        assert np.array_equal(got, want), eps
        with np.errstate(over="ignore", invalid="ignore"):
            q = np.abs(x.astype(np.float64) / eps)
        assert not fast[q >= 2.0**30].any()
        if eps >= 2 * F32_TINY:
            taken.append(fast.mean())
        else:
            assert not fast.any()
    assert min(taken) > 0.5


@pytest.mark.parametrize("w", [16, 32])
def test_encode_values_model_equals_plain(rng, w):
    """Kernel 4's row by thread: each thread's 32 bins, the predecessor of
    its first cell by a shuffle from the thread before or (a warp's first
    lane) that cell quantized once more, then the integer encode's row."""
    length = geometry(w)["L"]
    elems, batch = length + 37, 2
    x = (rng.standard_normal((batch, elems)) * (30.0 if w == 16 else 3e4)
         ).astype(np.float32)
    x[0, :3] = [np.inf, -np.nan, -0.0]
    x[1, 1000:1040] = np.float32(1e-41)
    eps = np.array([1e-3, 0.37])
    bins = np.stack([model_quantize(x[i], eps[i])[0] for i in range(batch)])
    cpt = -(-elems // length)
    padded = np.zeros((batch, cpt * length), np.int32)
    padded[:, :elems] = bins
    for i in range(batch):
        for c in range(cpt):
            row = padded[i, c * length: (c + 1) * length].reshape(-1, 32)
            shuffled = np.concatenate([[0], row[:-1, 31]])
            e = c * length + 32 * np.arange(row.shape[0]) - 1
            first = (np.arange(row.shape[0]) % 32 == 0) & (e >= c * length)
            again = model_quantize(x[i, e[first & (e < elems)]], eps[i])[0]
            prev = shuffled.copy()
            prev[first] = 0
            prev[np.flatnonzero(first)[: again.size]] = again
            assert np.array_equal(prev, shuffled)
    narrow = padded[:, :elems].astype(SIGNED[w])
    got = model_encode(narrow, "delta")
    want = pt_fe.encode_values_plain(torch.from_numpy(x), torch.from_numpy(eps),
                                     length, torch.float32,
                                     getattr(torch, f"int{w}"))
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())
