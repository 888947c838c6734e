// Fused lossless encode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `encode_ints_fused` of
// src/repro/kernels/fused_encode.py (`_collapse_ints`, `_encode_call`).
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
//
// What bounds it on this card: bytes.  Every input word is read once and
// every output word written once; the transpose is a few integer
// instructions per bit.  One CTA owns one chunk row.  Warps walk groups
// of 32 words (64 for W = 64); `__ballot_sync` over one bit of every
// lane's word yields 32 bits of one plane in one instruction (`__brev`
// turns lane order into MSB-first order; W = 16 splits a ballot into two
// plane words, W = 64 joins two).  The shuffled chunk is staged in shared
// memory so the bitmap ballots and the store to device memory are
// coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

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
    uint32_t k0a = 0, k0b = 0, k1a = 0, k1b = 0;
#pragma unroll
    for (int p = 0; p < 64; ++p) {
      const uint32_t ba = __ballot_sync(kFull, (unsigned)((u0 >> (63 - p)) & 1u));
      const uint32_t bb = __ballot_sync(kFull, (unsigned)((u1 >> (63 - p)) & 1u));
      if (lane == (p & 31)) {
        if (p < 32) { k0a = ba; k0b = bb; } else { k1a = ba; k1b = bb; }
      }
    }
    sh[lane * P + g] = ((U)__brev(k0a) << 32) | (U)__brev(k0b);
    sh[(lane + 32) * P + g] = ((U)__brev(k1a) << 32) | (U)__brev(k1b);
  } else {
    uint32_t keep = 0;
#pragma unroll
    for (int p = 0; p < W; ++p) {
      const uint32_t b = __ballot_sync(kFull, (unsigned)((u0 >> (W - 1 - p)) & 1u));
      if (lane == p) keep = b;
    }
    if (lane < W) {
      const uint32_t r = __brev(keep);
      if constexpr (W == 32) {
        sh[lane * P + g] = (U)r;
      } else {  // W == 16: a 32-word group fills two plane words
        sh[lane * P + 2 * g] = (U)(r >> 16);
        sh[lane * P + 2 * g + 1] = (U)(r & 0xffffu);
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const typename Word<W>::S* __restrict__ ints,
              typename Word<W>::U* __restrict__ bitmap,
              typename Word<W>::U* __restrict__ words,
              int32_t* __restrict__ counts, long long elems, int cpt,
              int mode) {
  using S = typename Word<W>::S;
  using U = typename Word<W>::U;
  constexpr int L = 131072 / W;
  constexpr int G = W == 64 ? 64 : 32;  // words per warp group
  __shared__ U sh[L];
  __shared__ int total;
  const int row = blockIdx.x;
  const long long tile = row / cpt;
  const int chunk = row - (int)(tile * cpt);
  const S* src = ints + tile * elems;
  const long long e0 = (long long)chunk * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nwarps = kThreads / 32;
  if (threadIdx.x == 0) total = 0;

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
  U* bm = bitmap + (long long)row * (L / W);
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
  if (lane == 0) atomicAdd(&total, cnt);

  U* dst = words + (long long)row * L;
  for (int j = threadIdx.x; j < L; j += kThreads) dst[j] = sh[j];
  __syncthreads();
  if (threadIdx.x == 0) counts[row] = total;
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

}  // extern "C"
