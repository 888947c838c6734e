// Fused lossless encode for Hopper (sm_90a), and the fused value encode
// of the plain (preserve_order=False) f32 path.
//
// Replaces the Pallas TPU kernels `encode_ints_fused` and
// `encode_values_fused` of src/repro/kernels/fused_encode.py
// (`_collapse_ints`, `_encode_call`).
//
// What it computes, per 16 KiB chunk of a (batch, elems) integer tile
// batch (each tile padded with zeros to whole chunks):
//   - the word transform: delta (each element minus its predecessor in
//     the chunk, the first kept) then zigzag, zigzag alone (a chain's bin
//     residuals), or a raw reinterpretation, all wrapping in the word
//     width W;
//   - the BIT_W transpose: plane b (MSB first) goes to words
//     [b*L/W, (b+1)*L/W), bit j of a plane word (MSB first) being bit
//     W-1-b of word j;
//   - the MSB-first RZE bitmap of the shuffled words and its popcount.
// The value encode (`lopc_encode_values`) first makes those integers
// from a (batch, elems) f32 batch and a (batch,) f64 eps: non-finite
// cells take bin 0, every other cell is quantized by the op sequence of
// `quantize_broadcast` (x to f64, round half to even of x / eps, then
// two passes of verify-and-correct against decode_base(b) and
// decode_base(b + 1), compared as f32; subnormal operands and results
// flushed to signed zeros as XLA does, ftz.cuh), the int32 bin wraps to
// the W-bit store width, and the delta chain above runs on the result.
// Only a cell can be subnormal at every eps: the bases are at least
// eps / 2 in magnitude, so the tiles with eps >= 2 * FLT_MIN run an
// instantiation without the other flushes (a subnormal quotient rounds
// to bin 0 either way).
//
// What bounds it on this card: bytes for the integer encode (every input
// word read once, every output word written once), provided the
// transpose costs few instructions per word and enough loads are in
// flight (W ballots per 32 words with one 32-word group in flight per
// warp make it issue- and latency-bound).  One CTA owns one chunk row.
//   - W = 16 (every main-path stream) and W = 32: thread t owns words
//     32t .. 32t+31, loads them 16 bytes at a time, takes the delta and
//     zigzag (at W = 16 two halfwords at a time), and transposes them in
//     registers (transpose16x2 / transpose32 of lane_transpose.cuh:
//     delta swaps, no shuffle); the result is its columns of every plane,
//     stored straight to device memory, 128 contiguous bytes a warp, and
//     balloted into the bitmap.  No shared memory but the count; a CTA
//     has L / 32 threads (256 at W = 16, 128 at W = 32).
//   - W = 64: each warp owns a contiguous run of units of 64 words and
//     issues the loads of its units before it transforms any
//     (consecutive lanes on consecutive words; the delta's predecessor
//     from the next lane down by a shuffle, across units from lane 31 of
//     the unit before).  The transpose is the shuffle butterfly of
//     lane_transpose.cuh, which leaves plane p's word in lane p; the
//     planes are staged in shared memory with 8 bytes of padding after
//     each, so the 32 lanes' stores hit distinct banks, and a second pass
//     stores them in order and ballots the bitmap and its popcount from
//     the same registers.
// The value encode (W = 16 and 32) is bound by bytes too, provided the
// quantize's f64 work fits beneath them (f64 operations run at 64 and
// 64-bit conversions at 16 a clock on an SM): thread t loads its 32 cells
// 16 bytes at a time, quantizes them in registers and runs the W-bit
// row code above on the bins, the predecessor of cell 32t by a shuffle
// (a warp's first lane quantizes that cell once more).  A cell costs one
// f32 -> f64 conversion and six f64 operations (`quantize_fast`, which
// says why its bin is the reference's): the quotient by a multiply with
// the tile's rounded 1 / eps, rounded to an integer by adding and
// subtracting 1.5 * 2^52, and a test that it lies clear of every
// half-integer, where the reference's corrections cannot move it.  The
// few cells it cannot vouch for (within 2^-20 of a half-integer, |q| >=
// 2^30, non-finite) and every cell of a TINY tile run the reference's
// sequence (`quantize_f32`: the IEEE f64 divide, `rint`, two passes over
// the decode bases cast by __double2float_rn).  Built with -fmad=false
// and no fast-math; the quantize's f64 operations are the _rn
// intrinsics, which are never fused or reassociated.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clocks.cuh"
#include "ftz.cuh"
#include "lane_transpose.cuh"

namespace {

constexpr int kThreads = 256;  // a CTA's threads, but 128 at W = 32
constexpr int kWarps = kThreads / 32;

// threads of a CTA at word width W: one per 32 words at W = 16 and 32
template <int W>
__host__ __device__ constexpr int block_threads() {
  return W == 32 ? 128 : kThreads;
}
constexpr unsigned kFull = 0xffffffffu;

enum Transform { kRaw = 0, kDelta = 1, kZigzag = 2 };

template <int W> struct Word;
template <> struct Word<16> { using S = int16_t; using U = uint16_t; };
template <> struct Word<32> { using S = int32_t; using U = uint32_t; };
template <> struct Word<64> { using S = int64_t; using U = uint64_t; };

// One W-bit chunk row and its shared staging buffer (used at W = 64:
// the planes, each padded by one word)
template <int W>
struct Chunk {
  static constexpr int L = 131072 / W;          // words per 16 KiB chunk
  static constexpr int P = L / W;               // words per plane
  static constexpr int STAGE = W == 64 ? W * (P + 1) : 8;
};

// 8 bits spread to the even bits of 16
__device__ __forceinline__ uint32_t spread8(uint32_t h) {
  h = (h | (h << 4)) & 0x0f0fu;
  h = (h | (h << 2)) & 0x3333u;
  return (h | (h << 1)) & 0x5555u;
}

// W = 16: thread t owns words 32t .. 32t + 31 of the row (kThreads * 32
// = L), x[i] holding words 2i (low half) and 2i + 1, and `pred()` gives
// the predecessor of word 32t in its high half (0 for word 0), read
// only for the delta: delta and zigzag on halfword pairs (the zigzag
// alone in mode kZigzag), then two
// 16 x 16 transposes in registers (transpose16x2) give its two columns
// q = 2t, 2t + 1 of every plane, stored as one 32-bit word a lane (a
// warp's 32 lanes: 128 contiguous bytes of the plane) and balloted into
// the bitmap; no staging.  Adds the row's count to `total`.
template <typename Pred>
__device__ __forceinline__ void encode_regs16(uint32_t (&x)[16], Pred pred,
                                              long long row,
                                              uint16_t* __restrict__ bitmap,
                                              uint16_t* __restrict__ words,
                                              int mode, int* total) {
  constexpr int L = Chunk<16>::L, P = Chunk<16>::P;
  static_assert(kThreads * 32 == L, "one thread per 32 words");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (mode == kDelta) {
    uint32_t prev = pred();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t d = __vsub2(x[i], __byte_perm(prev, x[i], 0x5432));
      prev = x[i];
      // zigzag per halfword: (d << 1) ^ (d >> 15), the shift arithmetic
      x[i] = ((d << 1) & 0xFFFEFFFEu) ^ __vcmplts2(d, 0u);
    }
  } else if (mode == kZigzag) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = ((x[i] << 1) & 0xFFFEFFFEu) ^ __vcmplts2(x[i], 0u);
  }
  // rows of the two matrices: y[r] = words r (low) and 16 + r (high)
  uint32_t y[16];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    y[r] = __byte_perm(x[r / 2], x[8 + r / 2], (r & 1) ? 0x7632 : 0x5410);
  transpose16x2(y);  // y[p]: plane p's words at columns 2t (low), 2t + 1
  uint32_t* dst = reinterpret_cast<uint32_t*>(words + row * L);
  uint16_t* bm = bitmap + row * P;
  int cnt = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    dst[p * (P / 2) + t] = y[p];
    const uint32_t b0 = __ballot_sync(kFull, (y[p] & 0xffffu) != 0);
    const uint32_t b1 = __ballot_sync(kFull, (y[p] >> 16) != 0);
    cnt += __popc(b0) + __popc(b1);
    if (lane < 4) {  // bit i of z: word p * P + 64 * warp + 16 * lane + i
      const uint32_t z = spread8((b0 >> (8 * lane)) & 0xffu) |
                         (spread8((b1 >> (8 * lane)) & 0xffu) << 1);
      bm[p * (P / 16) + 4 * warp + lane] = (uint16_t)(__brev(z) >> 16);
    }
  }
  __syncthreads();  // `total` was zeroed
  if (lane == 0) atomicAdd(total, cnt);
}

// W = 16 from memory: words 32t .. 32t + 31 of the row loaded 16 bytes at
// a time (those at or past `elems` read as 0), then encode_regs16.
__device__ __forceinline__ void encode_row16(const int16_t* src, long long e0,
                                             long long elems, long long row,
                                             uint16_t* __restrict__ bitmap,
                                             uint16_t* __restrict__ words,
                                             int mode, int* total) {
  const int t = threadIdx.x;
  const long long e = e0 + 32 * t;
  const int16_t* in = src + e;
  uint32_t x[16];  // x[i]: words 2i (low half) and 2i + 1
  if (e + 32 <= elems && ((uintptr_t)in & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(in)[i];
      x[4 * i] = q.x, x[4 * i + 1] = q.y, x[4 * i + 2] = q.z, x[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t a = e + 2 * i < elems ? (uint16_t)in[2 * i] : 0u;
      const uint32_t b = e + 2 * i + 1 < elems ? (uint16_t)in[2 * i + 1] : 0u;
      x[i] = a | (b << 16);
    }
  }
  // the predecessor of word 32t in a high half (none for word 0)
  const auto pred = [&] {
    return t > 0 && e - 1 < elems ? (uint32_t)(uint16_t)in[-1] << 16 : 0u;
  };
  encode_regs16(x, pred, row, bitmap, words, mode, total);
}

// W = 32: thread t (of 128) owns words 32t .. 32t + 31 of the row in x,
// and `pred()` gives the predecessor of word 32t (0 for word 0), read
// only for the delta: delta and zigzag (zigzag alone in mode kZigzag),
// then the transpose in registers
// (transpose32) gives its column q = t of every plane, stored straight to
// device memory, 128 contiguous bytes a warp, and balloted into the
// bitmap.  Adds the row's count to `total`.
template <typename Pred>
__device__ __forceinline__ void encode_regs32(uint32_t (&x)[32], Pred pred,
                                              long long row,
                                              uint32_t* __restrict__ bitmap,
                                              uint32_t* __restrict__ words,
                                              int mode, int* total) {
  constexpr int L = Chunk<32>::L, P = Chunk<32>::P;
  static_assert(block_threads<32>() * 32 == L, "one thread per 32 words");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (mode == kDelta) {
    uint32_t prev = pred();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t d = x[i] - prev;
      prev = x[i];
      // zigzag: (d << 1) ^ (d >> 31), the shift arithmetic
      x[i] = (d << 1) ^ (uint32_t)((int32_t)d >> 31);
    }
  } else if (mode == kZigzag) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[i] = (x[i] << 1) ^ (uint32_t)((int32_t)x[i] >> 31);
  }
  transpose32(x);  // x[p]: plane p's word at column t
  uint32_t* dst = words + row * L;
  uint32_t* bm = bitmap + row * P;
  int cnt = 0;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    dst[p * P + t] = x[p];
    const uint32_t b = __ballot_sync(kFull, x[p] != 0);
    cnt += __popc(b);
    if (lane == 0) bm[p * (P / 32) + warp] = __brev(b);
  }
  __syncthreads();  // `total` was zeroed
  if (lane == 0) atomicAdd(total, cnt);
}

// W = 32 from memory: words 32t .. 32t + 31 of the row (load_words32 of
// lane_transpose.cuh, shared with the BIT_4 transpose), then
// encode_regs32.
__device__ __forceinline__ void encode_row32(const int32_t* src, long long e0,
                                             long long elems, long long row,
                                             uint32_t* __restrict__ bitmap,
                                             uint32_t* __restrict__ words,
                                             int mode, int* total) {
  const int t = threadIdx.x;
  const long long e = e0 + 32 * t;
  const uint32_t* in = reinterpret_cast<const uint32_t*>(src + e);
  uint32_t x[32];
  load_words32(in, elems - e, x);
  // the predecessor of word 32t (none for word 0)
  const auto pred = [&] { return t > 0 && e - 1 < elems ? in[-1] : 0u; };
  encode_regs32(x, pred, row, bitmap, words, mode, total);
}

// W = 64: the shuffle butterfly, a warp per run of units, the planes
// staged in shared memory; adds the row's count to `total`.
__device__ __forceinline__ void encode_row64(const int64_t* src, long long e0,
                                             long long elems, long long row,
                                             uint64_t* __restrict__ bitmap,
                                             uint64_t* __restrict__ words,
                                             int mode, uint64_t* stage,
                                             int* total) {
  constexpr int W = 64;
  using S = int64_t;
  using U = uint64_t;
  constexpr int L = Chunk<W>::L, P = Chunk<W>::P, G = 64;  // G: unit words
  constexpr int STRIDE = P + 1;
  constexpr int UPW = L / G / kWarps;      // units per warp
  constexpr int BATCH = UPW < 16 ? UPW : 16;
  constexpr int V = G / 32;                // words per lane per unit
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = e0 + (long long)warp * UPW * G;
  // the delta's predecessor of the warp's first word (none for the
  // chunk's first word, which keeps its value)
  U carry = 0;
  if (mode == kDelta && warp > 0 && first - 1 < elems) carry = (U)src[first - 1];
  for (int k0 = 0; k0 < UPW; k0 += BATCH) {
    U v[BATCH][V];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
#pragma unroll
      for (int h = 0; h < V; ++h) {
        const long long e = first + (long long)(k0 + k) * G + 32 * h + lane;
        v[k][h] = e < elems ? (U)src[e] : (U)0;
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      U x[2];
#pragma unroll
      for (int h = 0; h < V; ++h) {
        U d = v[k][h];
        if (mode == kDelta) {
          const U up = shfl_up(d, 1);
          const U prev = lane ? up : carry;
          carry = shfl(d, 31);
          d = (U)(d - prev);
          // zigzag: (d << 1) ^ (d >> (W-1)), the right shift arithmetic
          const U sign = (U)((S)d < 0 ? ~(U)0 : (U)0);
          d = (U)((U)(d << 1) ^ sign);
        } else if (mode == kZigzag) {
          const U sign = (U)((S)d < 0 ? ~(U)0 : (U)0);
          d = (U)((U)(d << 1) ^ sign);
        }
        x[h] = d;
      }
      const int u = warp * UPW + k0 + k;
      transpose_lanes64(x[0], x[1], lane);
      stage[lane * STRIDE + u] = x[0];
      stage[(lane + 32) * STRIDE + u] = x[1];
    }
  }
  __syncthreads();
  CLOCK_MARK(0);

  // the staged words in order to device memory, with the RZE bitmap (MSB
  // first) and its popcount from the same registers
  int cnt = 0;
  U* bm = bitmap + row * P;
  U* dst = words + row * L;
  // a pass is one bitmap word, two planes of 32
  for (int g = warp; g < L / 64; g += kWarps) {
    const U w0 = stage[(2 * g) * STRIDE + lane];
    const U w1 = stage[(2 * g + 1) * STRIDE + lane];
    dst[g * 64 + lane] = w0;
    dst[g * 64 + 32 + lane] = w1;
    const uint32_t b0 = __ballot_sync(kFull, w0 != 0);
    const uint32_t b1 = __ballot_sync(kFull, w1 != 0);
    cnt += __popc(b0) + __popc(b1);
    if (lane == 0) bm[g] = ((U)__brev(b0) << 32) | (U)__brev(b1);
  }
  if (lane == 0) atomicAdd(total, cnt);
}

// Encode one chunk row from `src` (the row's elements e0, e0 + 1, ...,
// those at or past `elems` read as 0) into the bitmap, words and counts
// rows.  `stage` is the CTA's shared staging buffer (used at W = 64).
template <int W>
__device__ __forceinline__ void encode_chunk(
    const typename Word<W>::S* src, long long e0, long long elems,
    long long row, typename Word<W>::U* __restrict__ bitmap,
    typename Word<W>::U* __restrict__ words, int32_t* __restrict__ counts,
    int mode, typename Word<W>::U* stage, int* total) {
  if (threadIdx.x == 0) *total = 0;
  if constexpr (W == 16)
    encode_row16(src, e0, elems, row, bitmap, words, mode, total);
  else if constexpr (W == 32)
    encode_row32(src, e0, elems, row, bitmap, words, mode, total);
  else
    encode_row64(src, e0, elems, row, bitmap, words, mode, stage, total);
  __syncthreads();
  if (threadIdx.x == 0) counts[row] = *total;
  CLOCK_MARK(1);
  CLOCK_END();
}


// Two instantiations per width: raw and delta share one, the mode a
// uniform branch, and the zigzag has its own.  In the first the mode is
// `mode & 1`, which the compiler knows is never kZigzag, so the zigzag
// branches fold away and the raw and delta code stays what it was before
// the zigzag came (a kernel per transform ran the 16-bit delta 2% slower,
// by `encode_timing.py`).
template <int W, bool ZIGZAG>
__global__ void __launch_bounds__(block_threads<W>())
encode_kernel(const typename Word<W>::S* __restrict__ ints,
              typename Word<W>::U* __restrict__ bitmap,
              typename Word<W>::U* __restrict__ words,
              int32_t* __restrict__ counts, long long elems, int cpt,
              int mode) {
  constexpr int L = Chunk<W>::L;
  __shared__ __align__(16) typename Word<W>::U stage[Chunk<W>::STAGE];
  __shared__ int total;
  const long long row = blockIdx.x;
  const long long tile = row / cpt;
  const long long chunk = row - tile * cpt;
  CLOCK_START();
  encode_chunk<W>(ints + tile * elems, chunk * L, elems, row, bitmap, words,
                  counts, ZIGZAG ? (int)kZigzag : (mode & 1), stage, &total);
}

template <int W>
void launch_encode_ints(const void* ints, void* bitmap, void* words,
                        void* counts, unsigned rows, long long elems, int cpt,
                        int mode, cudaStream_t st) {
  using S = typename Word<W>::S;
  using U = typename Word<W>::U;
  const auto in = static_cast<const S*>(ints);
  const auto bm = static_cast<U*>(bitmap);
  const auto out = static_cast<U*>(words);
  const auto cnt = static_cast<int32_t*>(counts);
  constexpr int T = block_threads<W>();
  if (mode == kZigzag)
    encode_kernel<W, true><<<rows, T, 0, st>>>(in, bm, out, cnt, elems, cpt, mode);
  else
    encode_kernel<W, false><<<rows, T, 0, st>>>(in, bm, out, cnt, elems, cpt, mode);
}

// ---- the value encode (plain f32 path)

__device__ __forceinline__ int32_t f32_to_ordered(float v) {
  const int32_t b = __float_as_int(v);
  return b >= 0 ? b : (int32_t)(0x80000000u - (uint32_t)b);
}

__device__ __forceinline__ float ordered_to_f32(int32_t m) {
  const int32_t b = m >= 0 ? m : (int32_t)(0x80000000u - (uint32_t)m);
  return __int_as_float(b);
}

// `ftz` where the bin width is below 2 * FLT_MIN (TINY), else nothing:
// with a wider bin no base, cast or bump below can be subnormal
template <bool TINY, typename T>
__device__ __forceinline__ T ftz_tiny(T v) {
  if constexpr (TINY) return ftz(v);
  else return v;
}

// decode_base for f32: the smallest f32 >= (b - 0.5) * eps, computed in
// f64, cast to nearest, bumped one ordered step if the cast fell below.
template <bool TINY>
__device__ __forceinline__ float decode_base_f32(int32_t b, double eps) {
  // XLA flushes the subnormal eps, product and cast (DAZ/FTZ)
  const double t = ftz_tiny<TINY>(((double)b - 0.5) * ftz_tiny<TINY>(eps));
  float v = ftz_tiny<TINY>(__double2float_rn(t));
  if ((double)v < t) v = ordered_to_f32((int32_t)((uint32_t)f32_to_ordered(v) + 1u));
  return v;
}

// quantize_broadcast of one f32 cell by the reference's op sequence
// (non-finite cells quantize 0)
template <bool TINY>
__device__ __forceinline__ int32_t quantize_f32(float x, double eps) {
  if (!isfinite(x)) x = 0.0f;
  x = ftz(x);  // XLA reads a subnormal cell as zero (DAZ)
  // XLA flushes a subnormal eps and quotient (DAZ/FTZ)
  int32_t b = (int32_t)rint(
      ftz_tiny<TINY>((double)x / ftz_tiny<TINY>(eps)));
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    // XLA compares a subnormal base as zero (DAZ)
    const int too_high = x < ftz_tiny<TINY>(decode_base_f32<TINY>(b, eps));
    const int too_low = x >= ftz_tiny<TINY>(
        decode_base_f32<TINY>((int32_t)((uint32_t)b + 1u), eps));
    b = (int32_t)((uint32_t)b - (uint32_t)too_high + (uint32_t)too_low);
  }
  return b;
}

// 1.5 * 2^52: for |q| < 2^51, q + kRound lies in [2^52, 2^53), where
// consecutive doubles are 1 apart, so the sum rounds q half to even: the
// sum less kRound is rint(q), and its low 32 bits are rint(q) mod 2^32.
constexpr double kRound = 6755399441055744.0;

// The fast quantize of a cell x on a tile with eps >= 2 * FLT_MIN and a
// normal 1 / eps (rcp = 1 / eps rounded): sets b and returns true where b
// is the reference's bin; false sends the cell to quantize_f32 (a
// non-finite one to bin 0).  It is exact because, with Q = x / eps:
//  - the first guess: q = x * rcp rounded is within 2^-52 |Q| of Q, and
//    the reference's x / eps rounded within 2^-53 |Q|: each under 2^-22
//    for |Q| < 2^30 (where they underflow, both are about 0).  So where q
//    lies more than 2^-20 from every half-integer, both round to the same
//    integer r, without a tie: r is the reference's first guess;
//  - its two passes keep r: Q lies more than 2^-21 inside (r - 0.5,
//    r + 0.5), so x is above t = (r - 0.5) * eps as the reference rounds
//    it (off by at most 2^-53 |t| < 2^-22 eps) and below (r + 0.5) * eps
//    as rounded.  decode_base(r) is the least f32 >= t where |t| >=
//    FLT_MIN (the cast to nearest, bumped one step where it fell below
//    t), so the f32 x is not below it; decode_base(r + 1) is at least its
//    own t, so x is below it.  Neither pass moves r, and no base need be
//    evaluated here;
//  - the cells the reference reads otherwise: a subnormal x, read as a
//    zero (bin 0), has |q| < 1/2, so r = 0; a non-finite x has a
//    non-finite q and fails the test.
__device__ __forceinline__ bool quantize_fast(float x, double rcp, int32_t& b) {
  const double q = __dmul_rn((double)x, rcp);
  const double s = __dadd_rn(q, kRound);
  const double r = __dsub_rn(s, kRound);  // rint(q), for |q| < 2^51
  b = __double2loint(s);
  // q - r is exact (Sterbenz, or r = 0)
  return fabs(q) < 0x1p30 && fabs(__dsub_rn(q, r)) < 0.5 - 0x1p-20;
}

// One cell's bin: the fast path where the tile allows it (`fast`) and it
// holds, else the reference's sequence; a non-finite cell takes bin 0,
// as the reference's where(valid, bins, 0).
__device__ __forceinline__ int32_t quantize_cell(float x, double eps, double rcp,
                                                 bool fast, bool tiny) {
  int32_t b;
  if (fast && quantize_fast(x, rcp, b)) return b;
  if (!isfinite(x)) return 0;
  return tiny ? quantize_f32<true>(x, eps) : quantize_f32<false>(x, eps);
}

// The bins of a thread's 32 consecutive cells, c holding their bit
// patterns (a NaN for a cell past the tile, which takes bin 0 as the
// chunk's zero padding does) and `cell` their address: the fast path on
// every cell, then quantize_cell on the finite cells it cannot vouch for
// (every finite cell on a tile without the fast path), each read again.
// Non-finite cells, the tile pad among them, take bin 0 here.
__device__ __forceinline__ void quantize_cells(const uint32_t (&c)[32],
                                               int32_t (&b)[32],
                                               const float* cell, double eps,
                                               double rcp, bool fast,
                                               bool tiny) {
  uint32_t slow = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float x = __uint_as_float(c[i]);
    const bool fin = isfinite(x);
    int32_t bi;
    const bool ok = quantize_fast(x, rcp, bi);
    b[i] = fin ? bi : 0;
    slow |= (uint32_t)(fin && !(fast && ok)) << i;
  }
  CLOCK_COUNT(4, __popc(slow));
  while (slow) {
    const int i = __ffs(slow) - 1;
    slow &= slow - 1;
    const int32_t v = quantize_cell(cell[i], eps, rcp, fast, tiny);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k == i) b[k] = v;
  }
}

// cells past the tile load as this NaN (quantize_cells gives them bin 0)
constexpr uint32_t kPastTile = 0x7fc00000u;

// CTAs an SM must hold: at W = 16 four of 256 threads, so 64 registers a
// thread, for the warps that hide the quantize's f64 latencies; at
// W = 32 six of 128 (80 registers).  The phase-clock build with
// -DLOPC_OWN_REGISTERS leaves the budget to the compiler (about 90
// registers), to time that against this.
template <int W>
__host__ __device__ constexpr int value_min_blocks() {
  return W == 16 ? 4 : 6;
}
#if defined(LOPC_PHASE_CLOCKS) && defined(LOPC_OWN_REGISTERS)
#define VALUE_BOUNDS(W) __launch_bounds__(block_threads<W>())
#else
#define VALUE_BOUNDS(W) \
  __launch_bounds__(block_threads<W>(), value_min_blocks<W>())
#endif

template <int W>
__global__ void VALUE_BOUNDS(W)
encode_values_kernel(const float* __restrict__ x,
                     const double* __restrict__ eps,
                     typename Word<W>::U* __restrict__ bitmap,
                     typename Word<W>::U* __restrict__ words,
                     int32_t* __restrict__ counts, long long elems, int cpt) {
  static_assert(W == 16 || W == 32, "f32 bins store in 16 or 32 bits");
  constexpr int L = Chunk<W>::L;
  static_assert(block_threads<W>() * 32 == L, "one thread per 32 cells");
  __shared__ int total;
  const long long row = blockIdx.x;
  const long long tile = row / cpt;
  const long long e0 = (row - tile * cpt) * L;
  const float* src = x + tile * elems;
  const double tile_eps = eps[tile];
  // uniform over the CTA: a TINY tile runs the reference's sequence on
  // every cell, and the fast path needs a normal 1 / eps
  const bool tiny = tile_eps < 2.0 * FLT_MIN;
  const bool fast = !tiny && tile_eps <= 0x1p1000;
  const double rcp = 1.0 / tile_eps;
  const int t = threadIdx.x, lane = t & 31;
  if (t == 0) total = 0;
  CLOCK_START();
  // thread t: cells 32t .. 32t + 31 of the chunk, 16 bytes at a time
  const long long e = e0 + 32 * t;
  const float* cell = src + e;
  uint32_t c[32];
  load_words32(reinterpret_cast<const uint32_t*>(cell), elems - e, c, kPastTile);
  CLOCK_USE(c);
  CLOCK_MARK(3);
  int32_t b[32];
  quantize_cells(c, b, cell, tile_eps, rcp, fast, tiny);
  // the delta's predecessor of cell 32t: thread t - 1's last bin, by a
  // shuffle, or at a warp's first lane that cell quantized once more
  // (none for the chunk's first cell)
  int32_t prev = shfl_up(b[31], 1);
  if (lane == 0)
    prev = t > 0 && e - 1 < elems
               ? quantize_cell(cell[-1], tile_eps, rcp, fast, tiny) : 0;
  CLOCK_USE(b);
  CLOCK_MARK(2);
  // the wrapping narrowing to the store width, as astype(bins_store),
  // then the integer encode's delta chain from registers
  if constexpr (W == 16) {
    uint32_t h[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      h[i] = ((uint32_t)b[2 * i] & 0xffffu) | ((uint32_t)b[2 * i + 1] << 16);
    encode_regs16(h, [&] { return (uint32_t)prev << 16; }, row, bitmap, words,
                  kDelta, &total);
  } else {
    uint32_t w[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = (uint32_t)b[i];
    encode_regs32(w, [&] { return (uint32_t)prev; }, row, bitmap, words,
                  kDelta, &total);
  }
  __syncthreads();
  if (t == 0) counts[row] = total;
  CLOCK_MARK(1);
  CLOCK_END();
}

}  // namespace

CLOCK_EXPORTS(
    "W = 64: load+transform+transpose+stage loop,"
    "W = 16 and 32: the whole row (kernel 4: from its bins in registers);"
    " W = 64: copy-out+bitmap+count,"
    "kernel 4: quantize in registers,kernel 4: cell loads,"
    "kernel 4: cells by the reference's sequence (a count: hits are cells)")

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ints (batch, elems) intW; bitmap (batch*cpt, L/W), words (batch*cpt, L)
// W-bit words; counts (batch*cpt,) int32.  mode: 0 raw, 1 delta, 2 zigzag.
int lopc_encode_ints(const void* ints, void* bitmap, void* words,
                     void* counts, long long batch, long long elems,
                     long long word_bits, long long mode, void* stream) {
  const long long chunk_len = 131072 / word_bits;
  const long long cpt = (elems + chunk_len - 1) / chunk_len;
  const long long rows = batch * cpt;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)mode, c = (int)cpt;
  const unsigned r = (unsigned)rows;
  switch (word_bits) {
    case 16:
      launch_encode_ints<16>(ints, bitmap, words, counts, r, elems, c, m, st);
      break;
    case 32:
      launch_encode_ints<32>(ints, bitmap, words, counts, r, elems, c, m, st);
      break;
    case 64:
      launch_encode_ints<64>(ints, bitmap, words, counts, r, elems, c, m, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (batch, elems) f32, eps (batch,) f64; bitmap (batch*cpt, L/W), words
// (batch*cpt, L) W-bit words, W = 16 or 32; counts (batch*cpt,) int32.
int lopc_encode_values(const void* x, const void* eps, void* bitmap,
                       void* words, void* counts, long long batch,
                       long long elems, long long word_bits, void* stream) {
  const long long chunk_len = 131072 / word_bits;
  const long long cpt = (elems + chunk_len - 1) / chunk_len;
  const long long rows = batch * cpt;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const double* es = static_cast<const double*>(eps);
  switch (word_bits) {
    case 16:
      encode_values_kernel<16><<<(unsigned)rows, block_threads<16>(), 0, st>>>(
          xs, es, static_cast<uint16_t*>(bitmap),
          static_cast<uint16_t*>(words), static_cast<int32_t*>(counts),
          elems, (int)cpt);
      break;
    case 32:
      encode_values_kernel<32><<<(unsigned)rows, block_threads<32>(), 0, st>>>(
          xs, es, static_cast<uint32_t*>(bitmap),
          static_cast<uint32_t*>(words), static_cast<int32_t*>(counts),
          elems, (int)cpt);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
