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
``fused_encode.cu`` does.  No jax and no reference: the plain versions are
held to the reference elsewhere (tests/test_torch_kernels.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.floatbits import float_to_ordered, int_dtype_for, ordered_to_float
from repro_torch.core.quantize import decode_base
from repro_torch.kernels import fused_decode as pt_fd
from repro_torch.kernels import fused_encode as pt_fe

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


@pytest.mark.parametrize("transform", ["delta", "raw"])
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
