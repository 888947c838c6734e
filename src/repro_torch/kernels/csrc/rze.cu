// RZE bitmap and nonzero counts for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rze_bitmap_u32` of
// src/repro/kernels/rze_kernel.py (`_rze_kernel`).
//
// What it computes, per 4096-word chunk of 32-bit words: a 128-word
// bitmap whose bit j (MSB first within each bitmap word) says word j is
// nonzero, and the chunk's nonzero count.  As on the TPU, the compaction
// of the nonzero words is not part of the kernel (the caller runs it).
//
// What bounds it on this card: bytes (the words are read once; the
// bitmap is 1/32 of them).  One CTA of eight warps owns one chunk; a warp
// takes 32 words, one per lane, and one `__ballot_sync(word != 0)` is a
// bitmap word in lane order, `__brev` makes it MSB-first and `__popc`
// counts it.  Each warp sums its counts and the CTA adds the warps' sums
// in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;
constexpr int kBitmapWords = kChunk / 32;  // 128
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
rze_bitmap_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ bitmap,
                  int32_t* __restrict__ counts) {
  __shared__ int total;
  const long long c = blockIdx.x;
  const uint32_t* src = in + c * kChunk;
  uint32_t* bm = bitmap + c * kBitmapWords;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  int cnt = 0;
  for (int g = warp; g < kBitmapWords; g += kWarps) {
    const uint32_t b = __ballot_sync(0xffffffffu, src[g * 32 + lane] != 0u);
    cnt += __popc(b);
    if (lane == 0) bm[g] = __brev(b);
  }
  if (lane == 0) atomicAdd(&total, cnt);
  __syncthreads();
  if (threadIdx.x == 0) counts[c] = total;
}

}  // namespace

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// words (chunks, 4096) 32-bit words -> bitmap (chunks, 128) 32-bit words,
// counts (chunks,) int32.
int lopc_rze_bitmap(const void* words, void* bitmap, void* counts,
                    long long chunks, void* stream) {
  if (chunks == 0) return 0;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rze_bitmap_kernel<<<(unsigned)chunks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(bitmap),
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}

}  // extern "C"
