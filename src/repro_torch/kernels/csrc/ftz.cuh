// The reference's subnormal flushes, written out (shared by the quantize
// and decode kernels).
//
// XLA runs with denormals-are-zero and flush-to-zero: an arithmetic op or
// a comparison reads a subnormal operand as a zero of its sign and writes
// a subnormal result as one (bitcasts and selects pass bits through).  The
// card has no FTZ mode for f64, and the f32 one would also flush where the
// reference passes bits through, so every operand and result that can be
// subnormal is flushed by hand with `ftz`.  Only a bin width within about
// 2x of the smallest normal, or a subnormal cell, ever meets one.
#pragma once

#include <float.h>

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ double ftz(double v) {
  return fabs(v) < DBL_MIN ? copysign(0.0, v) : v;
}
