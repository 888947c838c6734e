// The MSB-first bit-plane transpose of 32 words held one per lane of a
// warp, by ballots, for the BIT_4 transpose (bitshuffle.cu); the fused
// encode and decode use the transposes of lane_transpose.cuh.
//
// `__ballot_sync` over bit (NB-1-p) of every lane's value gives plane p's
// bits in lane order (lane i at bit i); `__brev` turns that into MSB-first
// order (lane i at bit 31-i).  Lane p keeps plane p's word.  Applied to
// 32 plane words it is its own inverse: lane i gets word i back.
#pragma once

#include <stdint.h>

template <int NB>
__device__ __forceinline__ uint32_t ballot_planes(uint32_t v, int lane) {
  uint32_t keep = 0;
#pragma unroll
  for (int p = 0; p < NB; ++p) {
    const uint32_t b = __ballot_sync(0xffffffffu, (v >> (NB - 1 - p)) & 1u);
    if (lane == p) keep = b;
  }
  return __brev(keep);
}
