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
// That is the fused encode's BIT_32 layout (fused_encode.cu at W = 32).
//
// What bounds it on this card: bytes (each word read once and written
// once), provided the transpose costs few instructions per word and
// enough loads are in flight.  One CTA of 128 threads owns one chunk;
// thread g owns plane-word column g, that is words 32g .. 32g+31, and
// transposes that 32 x 32 bit matrix in registers (`transpose32` of
// lane_transpose.cuh: 80 delta swaps, no shuffle, its own inverse).
//   - Forward: thread g loads its 32 words 16 bytes at a time
//     (`load_words32`, as the fused encode does) and stores plane p's
//     word g at 128p + g: a warp writes 128 contiguous bytes a plane.
//   - Inverse: thread g loads in[128p + g] for the 32 planes (32
//     independent loads, each coalesced across the warp), transposes,
//     and holds words 32g .. 32g+31.  They go through a shared stage of
//     one padded row per thread (36 words: eight consecutive threads'
//     16-byte stores fall in distinct banks), then the CTA copies the
//     chunk out 16 bytes a thread, 512 contiguous bytes a warp.
// The phase-clock build (-DLOPC_PHASE_CLOCKS, phase_clocks.py) marks the
// loads, the transpose and the stores; with -DLOPC_STRAIGHT_STORE beside
// it, the inverse stores each thread's 32 words straight to device
// memory instead (8 x 16 bytes), to time that choice against the stage.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clocks.cuh"
#include "lane_transpose.cuh"

namespace {

constexpr int kChunk = 4096;
constexpr int kPlaneWords = kChunk / 32;   // 128: one thread per column
constexpr int kThreads = kPlaneWords;
constexpr int kRow = 36;                   // padded shared row (inverse)

__global__ void __launch_bounds__(kThreads)
bitshuffle_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  const long long base = (long long)blockIdx.x * kChunk;
  const int g = threadIdx.x;
  CLOCK_START();
  uint32_t x[32];
  load_words32(in + base + 32 * g, 32, x);
  CLOCK_USE(x);
  CLOCK_MARK(0);
  transpose32(x);  // x[p]: plane p's word g
  CLOCK_USE(x);
  CLOCK_MARK(1);
#pragma unroll
  for (int p = 0; p < 32; ++p) out[base + p * kPlaneWords + g] = x[p];
  CLOCK_MARK(2);
  CLOCK_END();
}

__global__ void __launch_bounds__(kThreads)
bitunshuffle_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  const long long base = (long long)blockIdx.x * kChunk;
  const int g = threadIdx.x;
  CLOCK_START();
  uint32_t x[32];
#pragma unroll
  for (int p = 0; p < 32; ++p) x[p] = in[base + p * kPlaneWords + g];
  CLOCK_USE(x);
  CLOCK_MARK(3);
  transpose32(x);  // x[i]: word 32g + i
  CLOCK_USE(x);
  CLOCK_MARK(4);
#if defined(LOPC_PHASE_CLOCKS) && defined(LOPC_STRAIGHT_STORE)
  uint4* dst = reinterpret_cast<uint4*>(out + base + 32 * g);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = make_uint4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
#else
  __shared__ __align__(16) uint32_t sh[kThreads * kRow];
  uint4* row = reinterpret_cast<uint4*>(sh + g * kRow);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    row[i] = make_uint4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = threadIdx.x + k * kThreads;  // 16-byte unit of the chunk
    dst[j] = *reinterpret_cast<const uint4*>(sh + (j >> 3) * kRow + 4 * (j & 7));
  }
#endif
  CLOCK_MARK(5);
  CLOCK_END();
}

}  // namespace

CLOCK_EXPORTS(
    "forward: loads,forward: transpose,forward: stores,"
    "inverse: loads,inverse: transpose,inverse: stores")

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in, out (chunks, 4096) 32-bit words; inverse = 0 shuffles, 1 unshuffles.
// The inverse stores 16 bytes at a time: `out` must be 16-byte aligned.
int lopc_bitshuffle(const void* in, void* out, long long chunks,
                    long long inverse, void* stream) {
  if (chunks == 0) return 0;
  if (chunks > 0x7fffffffLL || (inverse && ((uintptr_t)out & 15)))
    return (int)cudaErrorInvalidValue;
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
