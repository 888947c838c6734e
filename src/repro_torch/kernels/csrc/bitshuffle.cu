// BIT_4 bit-plane transpose and its inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `bitshuffle_u32` / `bitunshuffle_u32`
// of src/repro/kernels/bitshuffle_kernel.py (`_bitshuffle_kernel`,
// `_bitunshuffle_kernel`).
//
// What it computes, per 4096-word chunk of 32-bit words: plane b (b = 0
// is the MSB) holds bit 31-b of every word, in words [128b, 128b + 128);
// plane word g holds words 32g .. 32g+31, word 32g+i at bit 31-i.  The
// inverse scatters the planes back.  Words travel as int32 bit patterns.
//
// What bounds it on this card: bytes (each word read once and written
// once; the transpose is a few instructions per bit).  One CTA of eight
// warps owns one chunk.  A warp takes 32 words, one per lane, and
// `ballot_planes` (ballot_transpose.cuh, shared with the fused encode)
// turns them into the 32 plane words of that group, one per lane; the
// transpose is its own inverse, so the unshuffle runs the same function
// on 32 plane words.  The chunk is staged in shared memory so both the
// load and the store to device memory are coalesced; a shared row holds
// one plane's 128 words padded to 129, so the 32 lanes' plane words of
// one group fall in 32 different banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ballot_transpose.cuh"

namespace {

constexpr int kChunk = 4096;
constexpr int kPlaneWords = kChunk / 32;   // 128
constexpr int kRow = kPlaneWords + 1;      // padded shared row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int staged(int j) {  // plane word j's slot
  return (j / kPlaneWords) * kRow + j % kPlaneWords;
}

__global__ void __launch_bounds__(kThreads)
bitshuffle_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  __shared__ uint32_t sh[32 * kRow];
  const long long base = (long long)blockIdx.x * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < kPlaneWords; g += kWarps) {
    const uint32_t v = in[base + g * 32 + lane];
    sh[lane * kRow + g] = ballot_planes<32>(v, lane);  // plane `lane`, word g
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kChunk; j += kThreads)
    out[base + j] = sh[staged(j)];
}

__global__ void __launch_bounds__(kThreads)
bitunshuffle_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  __shared__ uint32_t sh[32 * kRow];
  const long long base = (long long)blockIdx.x * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kChunk; j += kThreads)
    sh[staged(j)] = in[base + j];
  __syncthreads();
  for (int g = warp; g < kPlaneWords; g += kWarps) {
    const uint32_t v = sh[lane * kRow + g];  // plane `lane`, word g
    out[base + g * 32 + lane] = ballot_planes<32>(v, lane);
  }
}

}  // namespace

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in, out (chunks, 4096) 32-bit words; inverse = 0 shuffles, 1 unshuffles.
int lopc_bitshuffle(const void* in, void* out, long long chunks,
                    long long inverse, void* stream) {
  if (chunks == 0) return 0;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* src = static_cast<const uint32_t*>(in);
  auto* dst = static_cast<uint32_t*>(out);
  if (inverse)
    bitunshuffle_kernel<<<(unsigned)chunks, kThreads, 0, st>>>(src, dst);
  else
    bitshuffle_kernel<<<(unsigned)chunks, kThreads, 0, st>>>(src, dst);
  return (int)cudaGetLastError();
}

}  // extern "C"
