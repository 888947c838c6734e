// The FF32 quantize and dequantize pair for Hopper (sm_90a).
//
// 1. `lopc_quantize_ff32` replaces the Pallas TPU kernel `quantize_ff32`
//    of src/repro/kernels/quantize_kernel.py (body `_quantize_kernel`).
// 2. `lopc_dequantize_ff32` replaces the Pallas TPU kernel
//    `dequantize_ff32` of src/repro/kernels/fused_decode.py (body
//    `_decode_kernel`).
//
// What they compute (the FF32 contract, src/repro_torch/kernels/ref.py):
//     quantize:   b = sat_int32(rne(x * (1/eps))), then twice
//                 b += [x >= (f32(b) + 0.5) * eps] - [x < (f32(b) - 0.5) * eps]
//     dequantize: base = (f32(b) - 0.5) * eps; out = ordered^-1(ordered(base) + s)
// with every subnormal operand and result (eps, x, x * (1/eps), the
// bases) flushed to a signed zero, as XLA does (ftz.cuh).
// Every float op is one IEEE f32 op with round-to-nearest: the `__f*_rn`
// intrinsics are never contracted into a fused multiply-add (the build
// also passes -fmad=false), and 1/eps is the correctly rounded quotient.
// The float -> int32 conversion saturates as the reference's does (NaN
// -> 0, >= 2^31 -> INT32_MAX, < -2^31 -> INT32_MIN), written out rather
// than left to the conversion instruction.  The integer adds wrap; they
// are done in uint32, where wrapping is defined.
//
// What bounds them on this card: bytes.  Each is a flat elementwise pass
// (8 bytes per element for the quantize, 12 for the dequantize) with a
// handful of float ops per element, far below the card's arithmetic
// rate.  The TPU kernels walk (256, 128) row blocks through VMEM; here
// the field stays flat, with no padding: each thread moves 16-byte
// vectors (float4 / int4) when every pointer is 16-byte aligned, in a
// grid-stride loop, and a scalar loop covers the tail.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ftz.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;

__device__ __forceinline__ int32_t sat_rint(float v) {
  const float r = rintf(v);  // round half to even
  if (r != r) return 0;
  if (r >= 2147483648.0f) return INT32_MAX;
  if (r < -2147483648.0f) return INT32_MIN;
  return (int32_t)r;
}

__device__ __forceinline__ int32_t quantize_one(float x, float inv,
                                                float eps) {
  x = ftz(x);  // XLA reads a subnormal cell as zero (DAZ)
  int32_t b = sat_rint(ftz(__fmul_rn(x, inv)));  // and flushes (FTZ)
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float bf = __int2float_rn(b);
    // XLA flushes a subnormal bound (FTZ)
    const float lo = ftz(__fmul_rn(__fsub_rn(bf, 0.5f), eps));
    const float hi = ftz(__fmul_rn(__fadd_rn(bf, 0.5f), eps));
    b = (int32_t)((uint32_t)b - (uint32_t)(x < lo) + (uint32_t)(x >= hi));
  }
  return b;
}

// int32 ordered space: m = bits if bits >= 0 else INT32_MIN - bits
__device__ __forceinline__ uint32_t to_ordered(uint32_t bits) {
  return (int32_t)bits >= 0 ? bits : 0x80000000u - bits;
}

__device__ __forceinline__ float dequantize_one(int32_t b, int32_t s,
                                                float eps) {
  // XLA flushes a subnormal base (FTZ)
  const float base = ftz(__fmul_rn(__fsub_rn(__int2float_rn(b), 0.5f), eps));
  const uint32_t m = to_ordered((uint32_t)__float_as_int(base)) + (uint32_t)s;
  return __int_as_float((int32_t)to_ordered(m));  // the map is an involution
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int32_t* __restrict__ out,
                long long n, float eps, int vec) {
  eps = ftz(eps);  // XLA reads a subnormal eps as zero (DAZ)
  const float inv = ftz(__fdiv_rn(1.0f, eps));  // and flushes (FTZ)
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long j = t; j < nv; j += stride) {
      const float4 v = x4[j];
      int4 r;
      r.x = quantize_one(v.x, inv, eps);
      r.y = quantize_one(v.y, inv, eps);
      r.z = quantize_one(v.z, inv, eps);
      r.w = quantize_one(v.w, inv, eps);
      o4[j] = r;
    }
    done = nv * 4;
  }
  for (long long j = done + t; j < n; j += stride)
    out[j] = quantize_one(x[j], inv, eps);
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int32_t* __restrict__ bins,
                  const int32_t* __restrict__ subs, float* __restrict__ out,
                  long long n, float eps, int vec) {
  eps = ftz(eps);  // XLA reads a subnormal eps as zero (DAZ)
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const int4* b4 = reinterpret_cast<const int4*>(bins);
    const int4* s4 = reinterpret_cast<const int4*>(subs);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = t; j < nv; j += stride) {
      const int4 b = b4[j];
      const int4 s = s4[j];
      float4 r;
      r.x = dequantize_one(b.x, s.x, eps);
      r.y = dequantize_one(b.y, s.y, eps);
      r.z = dequantize_one(b.z, s.z, eps);
      r.w = dequantize_one(b.w, s.w, eps);
      o4[j] = r;
    }
    done = nv * 4;
  }
  for (long long j = done + t; j < n; j += stride)
    out[j] = dequantize_one(bins[j], subs[j], eps);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned blocks_for(long long n) {
  long long b = (n / 4 + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (n,) f32 -> out (n,) int32 bins; eps the f32 bin width (passed as a
// double holding an f32 value exactly).
int lopc_quantize_ff32(const void* x, void* out, long long n, double eps,
                       void* stream) {
  if (n <= 0) return 0;
  const int vec = aligned16(x) && aligned16(out);
  quantize_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(out), n,
      (float)eps, vec);
  return (int)cudaGetLastError();
}

// bins, subs (n,) int32 -> out (n,) f32.
int lopc_dequantize_ff32(const void* bins, const void* subs, void* out,
                         long long n, double eps, void* stream) {
  if (n <= 0) return 0;
  const int vec = aligned16(bins) && aligned16(subs) && aligned16(out);
  dequantize_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), static_cast<const int32_t*>(subs),
      static_cast<float*>(out), n, (float)eps, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
