// In-kernel phase clocks for the fused decode and encode and the BIT_4
// transpose: `clock64()` deltas summed over CTAs into a small device
// buffer, read back by `lopc_clock_read`.  Compiled only with
// -DLOPC_PHASE_CLOCKS, the measurement build of `python -m
// repro_torch.kernels.phase_clocks`; without it every macro below is
// empty and the kernels are unchanged.
//
//   CLOCK_START()      thread 0 notes the CTA's start (CLOCK_END adds
//                      the CTA's slots to the device buffer);
//   CLOCK_MARK(k)      a barrier, then thread 0 adds the cycles since its
//                      last note to slot k (so slot k is the time the
//                      whole CTA took for the phase that ends there);
//   CLOCK_USE(x)       makes the phase that ends at the next mark wait
//                      for the registers of array x (a load's register is
//                      otherwise awaited at its first use, in a later
//                      phase, and the barrier does not wait for it);
//   CLOCK_COUNT(k, n)  any thread adds n to slot k's hits and no cycles
//                      (a count of events: the slot's hits are events),
//                      between the first mark and the last.
// A source names its slots in `lopc_clock_names` (comma-separated).
#pragma once

#ifdef LOPC_PHASE_CLOCKS

constexpr int kClockSlots = 16;
__device__ unsigned long long lopc_clock_sum[kClockSlots];
__device__ unsigned long long lopc_clock_hits[kClockSlots];

// thread 0's notes: [0] the clock at its last mark, then the CTA's
// cycles and hits per slot (added to the device buffer at its end)
__device__ __forceinline__ long long* clock_notes() {
  __shared__ long long notes[1 + 2 * kClockSlots];
  return notes;
}

__device__ __forceinline__ void clock_add(int k) {
  long long* n = clock_notes();
  const long long now = clock64();
  n[1 + k] += now - n[0];
  n[1 + kClockSlots + k] += 1;
  n[0] = clock64();
}

// a branch on the XOR of the array's 32-bit elements, which a thread
// cannot take before they have arrived
template <typename T, int N>
__device__ __forceinline__ void clock_use(const T (&x)[N]) {
  static_assert(sizeof(T) == 4, "32-bit elements");
  __shared__ unsigned sink;
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc ^= *reinterpret_cast<const unsigned*>(&x[i]);
  }
  if (acc == 0x9e3779b9u) sink = acc;
}

#define CLOCK_USE(x) clock_use(x)
#define CLOCK_COUNT(k, n)                                              \
  atomicAdd(reinterpret_cast<unsigned long long*>(                     \
                clock_notes() + 1 + kClockSlots + (k)),                \
            (unsigned long long)(n))
#define CLOCK_START()                                                  \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      long long* n_ = clock_notes();                                   \
      for (int i_ = 1; i_ < 1 + 2 * kClockSlots; ++i_) n_[i_] = 0;     \
      n_[0] = clock64();                                               \
    }                                                                  \
  } while (0)
#define CLOCK_MARK(k) \
  do { __syncthreads(); if (threadIdx.x == 0) clock_add(k); } while (0)
#define CLOCK_END()                                                    \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long* n_ = clock_notes();                             \
      for (int i_ = 0; i_ < kClockSlots; ++i_) {                       \
        if (!n_[1 + kClockSlots + i_]) continue;                       \
        atomicAdd(&lopc_clock_sum[i_], (unsigned long long)n_[1 + i_]); \
        atomicAdd(&lopc_clock_hits[i_],                                \
                  (unsigned long long)n_[1 + kClockSlots + i_]);       \
      }                                                                \
    }                                                                  \
  } while (0)

#define CLOCK_EXPORTS(names)                                           \
  extern "C" const char* lopc_clock_names() { return names; }          \
  extern "C" int lopc_clock_read(unsigned long long* sums,             \
                                 unsigned long long* hits) {           \
    cudaError_t e = cudaMemcpyFromSymbol(sums, lopc_clock_sum,         \
                                         sizeof(lopc_clock_sum));      \
    if (e == cudaSuccess)                                              \
      e = cudaMemcpyFromSymbol(hits, lopc_clock_hits,                  \
                               sizeof(lopc_clock_hits));               \
    static const unsigned long long zero[kClockSlots] = {};            \
    if (e == cudaSuccess)                                              \
      e = cudaMemcpyToSymbol(lopc_clock_sum, zero, sizeof(zero));      \
    if (e == cudaSuccess)                                              \
      e = cudaMemcpyToSymbol(lopc_clock_hits, zero, sizeof(zero));     \
    return (int)e;                                                     \
  }

#else

#define CLOCK_USE(x) do {} while (0)
#define CLOCK_COUNT(k, n) do {} while (0)
#define CLOCK_START() do {} while (0)
#define CLOCK_MARK(k) do {} while (0)
#define CLOCK_END() do {} while (0)
#define CLOCK_EXPORTS(names)

#endif
