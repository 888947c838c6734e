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
//     the chunk, the first kept) then zigzag, or a raw reinterpretation,
//     both wrapping in the word width W;
//   - the BIT_W transpose: plane b (MSB first) goes to words
//     [b*L/W, (b+1)*L/W), bit j of a plane word (MSB first) being bit
//     W-1-b of word j;
//   - the MSB-first RZE bitmap of the shuffled words and its popcount.
// The value encode (`lopc_encode_values`) first makes those integers
// from a (batch, elems) f32 batch and a (batch,) f64 eps: non-finite
// cells become 0, every cell is quantized by `quantize_broadcast`'s op
// sequence (x to f64, round half to even of x / eps, then two passes of
// verify-and-correct against decode_base(b) and decode_base(b + 1),
// compared as f32; subnormal operands and results flushed to signed
// zeros as XLA does, ftz.cuh), the int32 bin wraps to the W-bit store
// width, and the delta chain above runs on the result.  Only a cell can
// be subnormal at every eps: the bases are at least eps / 2 in magnitude,
// so the tiles with eps >= 2 * FLT_MIN run an instantiation without the
// other flushes (a subnormal quotient rounds to bin 0 either way).
//
// What bounds it on this card: bytes for the integer encode (every input
// word read once, every output word written once; the transpose is a few
// integer instructions per bit).  The value encode adds one f64 divide
// and four f64 decode_base evaluations per cell, which at the H100's f64
// rate still stays below its bytes time.  One CTA owns one chunk row.
// Warps walk groups of 32 words (64 for W = 64); `__ballot_sync` over one
// bit of every lane's word yields 32 bits of one plane in one
// instruction (`ballot_planes` of ballot_transpose.cuh, shared with the
// BIT_4 kernel; W = 16 splits a ballot into two plane words, W = 64 joins
// two).  The shuffled
// chunk is staged in shared memory so the bitmap ballots and the store to
// device memory are coalesced; the value encode stages its chunk's bins
// in a second shared buffer, so each cell is quantized once and the
// delta reads its neighbour from there.  Numerics: built with
// -fmad=false; the f64 divide is IEEE (no fast-math, no reciprocal),
// `rint` rounds half to even and the f32 cast is __double2float_rn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ballot_transpose.cuh"
#include "ftz.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Transform { kRaw = 0, kDelta = 1 };

template <int W> struct Word;
template <> struct Word<16> { using S = int16_t; using U = uint16_t; };
template <> struct Word<32> { using S = int32_t; using U = uint32_t; };
template <> struct Word<64> { using S = int64_t; using U = uint64_t; };

template <int W>
__device__ __forceinline__ typename Word<W>::U transform_word(
    const typename Word<W>::S* row, long long e, long long elems, int j,
    int mode) {
  using S = typename Word<W>::S;
  using U = typename Word<W>::U;
  const U v = e < elems ? (U)row[e] : (U)0;
  if (mode == kRaw) return v;
  U d = v;
  if (j > 0) {
    const U prev = (e - 1) < elems ? (U)row[e - 1] : (U)0;
    d = (U)(v - prev);
  }
  // zigzag: (d << 1) ^ (d >> (W-1)), the right shift arithmetic
  const U sign = (U)((S)d < 0 ? ~(U)0 : (U)0);
  return (U)((U)(d << 1) ^ sign);
}

// plane words of one group from per-lane words; writes into `sh`
template <int W>
__device__ __forceinline__ void shuffle_group(typename Word<W>::U* sh,
                                              typename Word<W>::U u0,
                                              typename Word<W>::U u1,
                                              int g, int lane) {
  using U = typename Word<W>::U;
  constexpr int L = 131072 / W;  // words per 16 KiB chunk
  constexpr int P = L / W;       // words per plane
  if constexpr (W == 64) {
    // planes 0-31 from the high halves, 32-63 from the low halves; the
    // lane's word (u0) fills a plane word's high half, u1 its low half
    const uint32_t a0 = ballot_planes<32>((uint32_t)(u0 >> 32), lane);
    const uint32_t b0 = ballot_planes<32>((uint32_t)(u1 >> 32), lane);
    const uint32_t a1 = ballot_planes<32>((uint32_t)u0, lane);
    const uint32_t b1 = ballot_planes<32>((uint32_t)u1, lane);
    sh[lane * P + g] = ((U)a0 << 32) | (U)b0;
    sh[(lane + 32) * P + g] = ((U)a1 << 32) | (U)b1;
  } else if constexpr (W == 32) {
    sh[lane * P + g] = (U)ballot_planes<32>((uint32_t)u0, lane);
  } else {  // W == 16: a 32-word group fills two plane words
    const uint32_t r = ballot_planes<16>((uint32_t)u0, lane);
    if (lane < 16) {
      sh[lane * P + 2 * g] = (U)(r >> 16);
      sh[lane * P + 2 * g + 1] = (U)(r & 0xffffu);
    }
  }
}

// Encode one chunk row from `src` (the row's elements e0, e0 + 1, ...,
// those at or past `elems` read as 0) into the bitmap, words and counts
// rows.  `sh` is the CTA's shared staging buffer of L words.
template <int W>
__device__ __forceinline__ void encode_chunk(
    const typename Word<W>::S* src, long long e0, long long elems,
    long long row, typename Word<W>::U* __restrict__ bitmap,
    typename Word<W>::U* __restrict__ words, int32_t* __restrict__ counts,
    int mode, typename Word<W>::U* sh, int* total) {
  using U = typename Word<W>::U;
  constexpr int L = 131072 / W;
  constexpr int G = W == 64 ? 64 : 32;  // words per warp group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = kThreads / 32;
  if (threadIdx.x == 0) *total = 0;

  for (int g = warp; g < L / G; g += nwarps) {
    const int j0 = g * G + lane;
    const U u0 = transform_word<W>(src, e0 + j0, elems, j0, mode);
    U u1 = 0;
    if constexpr (W == 64) u1 = transform_word<W>(src, e0 + j0 + 32, elems, j0 + 32, mode);
    shuffle_group<W>(sh, u0, u1, g, lane);
  }
  __syncthreads();

  // RZE bitmap over the shuffled words, MSB first, and its popcount
  int cnt = 0;
  U* bm = bitmap + row * (L / W);
  for (int g = warp; g < L / G; g += nwarps) {
    const uint32_t b0 = __ballot_sync(kFull, sh[g * G + lane] != 0);
    cnt += __popc(b0);
    if constexpr (W == 64) {
      const uint32_t b1 = __ballot_sync(kFull, sh[g * G + 32 + lane] != 0);
      cnt += __popc(b1);
      if (lane == 0) bm[g] = ((U)__brev(b0) << 32) | (U)__brev(b1);
    } else if constexpr (W == 32) {
      if (lane == 0) bm[g] = (U)__brev(b0);
    } else {
      if (lane == 0) {
        const uint32_t r = __brev(b0);
        bm[2 * g] = (U)(r >> 16);
        bm[2 * g + 1] = (U)(r & 0xffffu);
      }
    }
  }
  if (lane == 0) atomicAdd(total, cnt);

  U* dst = words + row * L;
  for (int j = threadIdx.x; j < L; j += kThreads) dst[j] = sh[j];
  __syncthreads();
  if (threadIdx.x == 0) counts[row] = *total;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const typename Word<W>::S* __restrict__ ints,
              typename Word<W>::U* __restrict__ bitmap,
              typename Word<W>::U* __restrict__ words,
              int32_t* __restrict__ counts, long long elems, int cpt,
              int mode) {
  constexpr int L = 131072 / W;
  __shared__ typename Word<W>::U sh[L];
  __shared__ int total;
  const long long row = blockIdx.x;
  const long long tile = row / cpt;
  const long long chunk = row - tile * cpt;
  encode_chunk<W>(ints + tile * elems, chunk * L, elems, row, bitmap, words,
                  counts, mode, sh, &total);
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

// quantize_broadcast of one f32 cell (non-finite cells quantize 0)
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

template <int W>
__global__ void __launch_bounds__(kThreads)
encode_values_kernel(const float* __restrict__ x,
                     const double* __restrict__ eps,
                     typename Word<W>::U* __restrict__ bitmap,
                     typename Word<W>::U* __restrict__ words,
                     int32_t* __restrict__ counts, long long elems, int cpt) {
  using S = typename Word<W>::S;
  using U = typename Word<W>::U;
  constexpr int L = 131072 / W;
  __shared__ U sh[L];
  __shared__ S bins[L];
  __shared__ int total;
  const long long row = blockIdx.x;
  const long long tile = row / cpt;
  const long long e0 = (row - tile * cpt) * L;
  const float* src = x + tile * elems;
  const double tile_eps = eps[tile];
  const bool tiny = tile_eps < 2.0 * FLT_MIN;  // uniform over the CTA
  for (int j = threadIdx.x; j < L; j += kThreads) {
    const long long e = e0 + j;
    const int32_t b = e >= elems ? 0
                      : tiny     ? quantize_f32<true>(src[e], tile_eps)
                                 : quantize_f32<false>(src[e], tile_eps);
    // the wrapping narrowing to the store width, as astype(bins_store)
    bins[j] = (S)(U)(uint32_t)b;
  }
  __syncthreads();
  encode_chunk<W>(bins, 0, L, row, bitmap, words, counts, kDelta, sh, &total);
}

}  // namespace

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ints (batch, elems) intW; bitmap (batch*cpt, L/W), words (batch*cpt, L)
// W-bit words; counts (batch*cpt,) int32.  mode: 0 raw, 1 delta.
int lopc_encode_ints(const void* ints, void* bitmap, void* words,
                     void* counts, long long batch, long long elems,
                     long long word_bits, long long mode, void* stream) {
  const long long chunk_len = 131072 / word_bits;
  const long long cpt = (elems + chunk_len - 1) / chunk_len;
  const long long rows = batch * cpt;
  if (rows == 0) return 0;
  if (rows > 0x7fffffffLL || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int m = (int)mode, c = (int)cpt;
  switch (word_bits) {
    case 16:
      encode_kernel<16><<<(unsigned)rows, kThreads, 0, st>>>(
          static_cast<const int16_t*>(ints), static_cast<uint16_t*>(bitmap),
          static_cast<uint16_t*>(words), static_cast<int32_t*>(counts),
          elems, c, m);
      break;
    case 32:
      encode_kernel<32><<<(unsigned)rows, kThreads, 0, st>>>(
          static_cast<const int32_t*>(ints), static_cast<uint32_t*>(bitmap),
          static_cast<uint32_t*>(words), static_cast<int32_t*>(counts),
          elems, c, m);
      break;
    case 64:
      encode_kernel<64><<<(unsigned)rows, kThreads, 0, st>>>(
          static_cast<const int64_t*>(ints), static_cast<uint64_t*>(bitmap),
          static_cast<uint64_t*>(words), static_cast<int32_t*>(counts),
          elems, c, m);
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
      encode_values_kernel<16><<<(unsigned)rows, kThreads, 0, st>>>(
          xs, es, static_cast<uint16_t*>(bitmap),
          static_cast<uint16_t*>(words), static_cast<int32_t*>(counts),
          elems, (int)cpt);
      break;
    case 32:
      encode_values_kernel<32><<<(unsigned)rows, kThreads, 0, st>>>(
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
