// The MSB-first bit-plane transpose of a group of words held one per
// lane, by a butterfly of warp shuffles, shared by the fused encode
// (fused_encode.cu) and the fused decode (fused_decode.cu); and the same
// transpose done by one thread in registers, which the BIT_4 transpose
// (bitshuffle.cu) shares with them.
//
// A group of W lanes holds a W x W bit matrix, lane r holding row r as a
// W-bit word whose column c is bit W-1-c.  The transpose leaves column r
// in lane r.  Applied to W consecutive words of a chunk it gives the W
// plane words of their column in the BIT_W layout (lane p: plane p, bit
// W-1-j holding bit W-1-p of word j), and applied to those plane words it
// gives the words back: it is its own inverse.  Each of the log2(W)
// stages swaps the off-diagonal j x j blocks of every 2j x 2j block: the
// upper lane of a pair (lane & j == 0) keeps its columns c with
// c & j == 0 and takes its partner's same columns, shifted j columns
// right; the lower lane the mirror image.  That is one shuffle, two
// shifts, a select and one bitwise merge per stage, against W ballots
// for a transpose by `__ballot_sync`.
//
//   W = 16: half-warps transpose independently, words in the low 16 bits;
//   W = 32: the warp;
//   W = 64: lane r holds rows r (x0) and r + 32 (x1); the first stage
//           (j = 32) is a swap inside each lane.
#pragma once

#include <stdint.h>

// Warp shuffles of a 32- or 64-bit word; a 64-bit word goes through the
// `unsigned long long` overloads (uint64_t is `unsigned long`, whose
// overloads a device compile may treat as 32 bits).
template <typename T>
__device__ __forceinline__ T shfl_xor(T x, int j) {
  if constexpr (sizeof(T) == 8)
    return (T)__shfl_xor_sync(0xffffffffu, (unsigned long long)x, j);
  else
    return __shfl_xor_sync(0xffffffffu, x, j);
}

template <typename T>
__device__ __forceinline__ T shfl_up(T x, int d) {
  if constexpr (sizeof(T) == 8)
    return (T)__shfl_up_sync(0xffffffffu, (unsigned long long)x, d);
  else
    return __shfl_up_sync(0xffffffffu, x, d);
}

template <typename T>
__device__ __forceinline__ T shfl(T x, int src) {
  if constexpr (sizeof(T) == 8)
    return (T)__shfl_sync(0xffffffffu, (unsigned long long)x, src);
  else
    return __shfl_sync(0xffffffffu, x, src);
}

// bits b of a word with b & j set: in MSB-first columns, c & j clear
__host__ __device__ constexpr uint32_t upper_columns(int j) {
  return j == 16 ? 0xFFFF0000u : j == 8 ? 0xFF00FF00u : j == 4 ? 0xF0F0F0F0u
       : j == 2 ? 0xCCCCCCCCu : 0xAAAAAAAAu;
}

template <int W, typename T>
__device__ __forceinline__ T transpose_stages(T x, int lane) {
#pragma unroll
  for (int j = (W == 16 ? 8 : 16); j >= 1; j >>= 1) {
    const T hi = sizeof(T) == 8 ? (T)(upper_columns(j) * 0x100000001ull)
                                : (T)upper_columns(j);
    const T y = shfl_xor(x, j);
    const bool lower = lane & j;
    const T moved = lower ? (T)(y << j) : (T)(y >> j);
    const T keep = lower ? (T)~hi : hi;
    x = (x & keep) | (moved & ~keep);
  }
  return x;
}

// W = 16 or 32: one word per lane (16-bit words in the low half)
template <int W>
__device__ __forceinline__ uint32_t transpose_lanes(uint32_t x, int lane) {
  static_assert(W == 16 || W == 32, "one word per lane");
  return transpose_stages<W, uint32_t>(x, lane);
}

// W = 64: rows lane (x0) and lane + 32 (x1)
__device__ __forceinline__ void transpose_lanes64(uint64_t& x0, uint64_t& x1,
                                                  int lane) {
  const uint64_t a = (x0 & 0xFFFFFFFF00000000ull) | (x1 >> 32);
  const uint64_t b = (x1 & 0x00000000FFFFFFFFull) | (x0 << 32);
  x0 = transpose_stages<64, uint64_t>(a, lane);
  x1 = transpose_stages<64, uint64_t>(b, lane);
}

// 32 consecutive 32-bit words from `in` into x[0 .. 31], those at or past
// `avail` as `fill`: 16 bytes at a time when all 32 are there and `in` is
// 16-byte aligned, else one at a time.  A thread that owns 32 consecutive
// words of a chunk owns their columns of every plane (transpose32 below).
__device__ __forceinline__ void load_words32(const uint32_t* in, long long avail,
                                             uint32_t (&x)[32],
                                             uint32_t fill = 0u) {
  if (avail >= 32 && ((uintptr_t)in & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(in)[i];
      x[4 * i] = q.x, x[4 * i + 1] = q.y, x[4 * i + 2] = q.z, x[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = i < avail ? in[i] : fill;
  }
}

// The same transpose done by one thread on a 32 x 32 matrix: x[r] holds
// row r (column c at bit 31 - c); afterwards x[c] holds column c.  Five
// stages of sixteen delta swaps, no shuffles (the fused encode at W = 32,
// the value encode's int32 bins, both directions of the BIT_4 transpose).
__device__ __forceinline__ void transpose32(uint32_t (&x)[32]) {
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    // the lower j bits of each 2j-bit group: the columns c & j
    const uint32_t lo = j == 16 ? 0x0000FFFFu : j == 8 ? 0x00FF00FFu
                      : j == 4 ? 0x0F0F0F0Fu : j == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if (r & j) continue;
      const uint32_t t = ((x[r + j] >> j) ^ x[r]) & lo;
      x[r] ^= t;
      x[r + j] ^= t << j;
    }
  }
}

// The same transpose done by one thread on two 16 x 16 matrices side by
// side: x[r] holds row r of matrix A in its low half and of matrix B in
// its high half (column c at bit 15 - c of a half); afterwards x[c] holds
// column c of each.  Four stages of eight delta swaps, no shuffles: the
// fused encode and decode take it for 16-bit words, each thread on 32
// consecutive words (two plane-word columns).
__device__ __forceinline__ void transpose16x2(uint32_t (&x)[16]) {
#pragma unroll
  for (int j = 8; j >= 1; j >>= 1) {
    // the lower j bits of each 2j-bit group of a half: the columns c & j
    const uint32_t lo = j == 8 ? 0x00FF00FFu : j == 4 ? 0x0F0F0F0Fu
                      : j == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & j) continue;
      const uint32_t t = ((x[r + j] >> j) ^ x[r]) & lo;
      x[r] ^= t;
      x[r + j] ^= t << j;
    }
  }
}
