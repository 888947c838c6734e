// Fused ordered decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_tiles_fused` of
// src/repro/kernels/fused_decode.py (`_expand_ints`).
//
// What it computes, per tile of a batch, from the two RZE streams of the
// v2 container (bins delta+zigzag coded, subbins raw):
//   - RZE expand: word j of a chunk is the next front-packed word when
//     bitmap bit j (MSB first) is set, else 0;
//   - the BIT_W un-transpose;
//   - bins: zigzag decode, then a wrapping inclusive prefix sum over the
//     chunk; subbins: the words as they are;
//   - decode_base in f64 with the tile's eps (f32: round-to-nearest cast
//     plus the one-ulp bump; subnormal operands and results flushed to
//     signed zeros as XLA does, ftz.cuh), then the ordered-int add of the
//     subbin:
//     out = ordered_to_float(float_to_ordered(base) + sub).
// Templated on the output float (f32 with int32 ordered ints, f64 with
// int64) and on both stream word widths; the reference kernel is f32-only
// for reasons of its TPU lowering, and its f64 staged chain computes the
// same function.  A second entry point, `lopc_decode_tiles_plain`, decodes
// a container without a subbin stream (preserve_order=False; the
// reference's `resident_decode_plain` chain): the same bins phase, then
// out = ordered_to_float(float_to_ordered(base) + 0), the ordered round
// trip kept as the reference keeps it (it maps -0.0 to +0.0).
//
// What bounds it on this card: bytes (the streams in, the values out),
// but at the main path's 128-tile batches the launch is short and
// latency-bound, so the design keeps the chain of dependent steps per CTA
// short and spreads the work over many CTAs, with no per-bit loop and no
// strided store.  One CTA owns one bins chunk row of one tile (the delta
// sum restarts at every row) and the subbin words of the same elements: at
// equal widths one subbin row, at a wider subbin word the 2 or 4 rows it
// takes, at a narrower one the part of a row it needs (each plane's
// columns q for the CTA's elements).  In order:
//   1. the bitmap rows, then (after one block-wide popcount prefix over
//      them, in 16-bit units) the front-packed words of every row, are
//      copied into shared memory with 16-byte `cp.async` copies, all in
//      flight together;
//   2. 16-bit rows (every main-path stream): thread t of 256 gathers its
//      two plane-word columns straight from shared memory and transposes
//      them in registers (transpose16x2 of lane_transpose.cuh), leaving
//      words 32t .. 32t + 31; at 16-bit bins and subbins, the first 256
//      threads take the bins row and the other 256 the subbin row at
//      once;  wider rows: the RZE expand fills a staging buffer whose
//      planes are padded by 4 bytes (8 for W = 64), so that the
//      transpose's reads, one plane per lane, hit distinct banks, and the
//      shuffle butterfly of lane_transpose.cuh leaves one word per lane;
//   3. the bins' dezigzag and wrapping prefix sum run on those registers
//      (within a thread, or warp scans, then one block scan), and the
//      decoded bins (and 16-bit subbins) go to shared memory in element
//      order;
//   4. every value is decoded and stored by consecutive threads to
//      consecutive addresses.
// Numerics: built with -fmad=false; f64 division is not used; the f64 ->
// f32 cast is __double2float_rn; unsigned right shifts are logical.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clocks.cuh"
#include "ftz.cuh"
#include "lane_transpose.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int lg2(int n) { return n <= 1 ? 0 : 1 + lg2(n / 2); }

// S, U: the stream word; R: the register a lane holds it in
template <int W> struct Word;
template <> struct Word<16> { using S = int16_t; using U = uint16_t; using R = uint32_t; };
template <> struct Word<32> { using S = int32_t; using U = uint32_t; using R = uint32_t; };
template <> struct Word<64> { using S = int64_t; using U = uint64_t; using R = uint64_t; };

template <typename F> struct Ord;
template <> struct Ord<float> {
  using I = int32_t;
  using UI = uint32_t;
  __device__ static I to_ordered(float v) {
    const int32_t b = __float_as_int(v);
    return b >= 0 ? b : (int32_t)(0x80000000u - (uint32_t)b);
  }
  __device__ static float from_ordered(int32_t m) {
    const int32_t b = m >= 0 ? m : (int32_t)(0x80000000u - (uint32_t)m);
    return __int_as_float(b);
  }
  __device__ static float base(long long bin, double eps) {
    // XLA flushes the subnormal eps, product and cast (DAZ/FTZ)
    const double t = ftz(((double)bin - 0.5) * ftz(eps));
    float v = ftz(__double2float_rn(t));
    if ((double)v < t) v = from_ordered((int32_t)((uint32_t)to_ordered(v) + 1u));
    return v;
  }
};
template <> struct Ord<double> {
  using I = int64_t;
  using UI = uint64_t;
  __device__ static I to_ordered(double v) {
    const int64_t b = __double_as_longlong(v);
    return b >= 0 ? b : (int64_t)(0x8000000000000000ull - (uint64_t)b);
  }
  __device__ static double from_ordered(int64_t m) {
    const int64_t b = m >= 0 ? m : (int64_t)(0x8000000000000000ull - (uint64_t)m);
    return __longlong_as_double(b);
  }
  __device__ static double base(long long bin, double eps) {
    // XLA flushes a subnormal eps and product (DAZ/FTZ)
    return ftz(((double)bin - 0.5) * ftz(eps));
  }
};

// One W-bit stream's 16 KiB chunk rows, and its staging buffer.
template <int W>
struct Chunk {
  static constexpr int L = 131072 / W;          // words (elements) per row
  static constexpr int P = L / W;               // bitmap words = words per plane
  static constexpr int G = W == 64 ? 64 : 32;   // elements per warp transpose
  static constexpr int STRIDE = P + (W == 16 ? 2 : 1);  // padded plane, words
  static constexpr int BITMAP_BYTES = P * W / 8;
  static constexpr int STAGE_BYTES = (W * STRIDE * (W / 8) + 15) / 16 * 16;
};

// The bins word BW and the subbin word SW (0: no subbin stream) of a CTA.
template <int BW, int SW>
struct Layout {
  using B = Chunk<BW>;
  using Sb = Chunk<SW == 0 ? 16 : SW>;
  // subbin rows one CTA may touch
  static constexpr int NSR = SW == 0 ? 0 : SW > BW ? SW / BW : 1;
  // 16-bit units of the bitmap rows; the popcount prefix has one more
  static constexpr int UNITS = (B::BITMAP_BYTES + NSR * Sb::BITMAP_BYTES) / 2;
  static constexpr int STAGE = B::STAGE_BYTES > Sb::STAGE_BYTES || SW == 0
                                   ? B::STAGE_BYTES : Sb::STAGE_BYTES;
  // byte offsets; every region is a multiple of 16 bytes
  static constexpr int BM = 0;                                  // bitmap rows
  static constexpr int PRE = BM + UNITS * 2;                    // int[UNITS + 1]
  static constexpr int PK_B = PRE + ((UNITS + 1) * 4 + 15) / 16 * 16;
  static constexpr int PK_S = PK_B + 16384;                     // NSR rows
  static constexpr int STG = PK_S + NSR * 16384;
  static constexpr int BINS = STG + STAGE;                      // decoded bins
  static constexpr int SUMS = BINS + (SW == 0 ? 0 : B::L * BW / 8);
  static constexpr int BYTES = SUMS + kWarps * 8;
  static_assert(UNITS <= 2 * kThreads, "one 32-bit bitmap word per thread");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// all threads: n 16-byte copies from device to shared memory, in flight
__device__ __forceinline__ void copy16(void* smem, const void* gmem, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    cp_async16(static_cast<uint4*>(smem) + i, static_cast<const uint4*>(gmem) + i);
}

// Exclusive offsets of the warps' totals (one per warp, uniform in it).
template <typename T>
__device__ T warp_offsets(T total, T* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sums[warp] = total;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kWarps ? sums[lane] : (T)0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_up(s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) sums[lane] = s;
  }
  __syncthreads();
  const T off = warp ? sums[warp - 1] : (T)0;
  __syncthreads();  // sums may be reused
  return off;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = shfl_up(x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Expand plane words (p, q), p < W, q in [qa, qa + 2^lg_nq), of one row
// into `stage` (plane p at p * STRIDE, q - qa within it).  `pre` holds the
// exclusive popcount prefix of the row's bitmap at each 16-bit unit, less
// `pre0`; `pk` is the row's front-packed words.
template <int W>
__device__ void expand(const typename Word<W>::U* bm, const int* pre, int pre0,
                       const typename Word<W>::U* pk,
                       typename Word<W>::U* stage, int qa, int lg_nq) {
  using U = typename Word<W>::U;
  constexpr int P = Chunk<W>::P, STRIDE = Chunk<W>::STRIDE;
  const int n = W << lg_nq;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int p = i >> lg_nq, qq = i & ((1 << lg_nq) - 1);
    const int j = p * P + qa + qq;
    const int m = j / W, r = j % W;
    const U word = bm[m];
    U v = 0;
    if ((word >> (W - 1 - r)) & 1) {
      const int above = r ? __popcll((unsigned long long)word >> (W - r)) : 0;
      v = pk[pre[m * (W / 16)] - pre0 + above];
    }
    stage[p * STRIDE + qq] = v;
  }
}

// The words of warp transpose unit u of a staged row, one element per
// lane (W = 64: elements lane and lane + 32 in x0 and x1).
template <int W>
__device__ __forceinline__ void untranspose(const typename Word<W>::U* stage,
                                            int u, typename Word<W>::R& x0,
                                            typename Word<W>::R& x1) {
  constexpr int STRIDE = Chunk<W>::STRIDE;
  const int lane = threadIdx.x & 31;
  if constexpr (W == 16) {
    x0 = transpose_lanes<16>(stage[(lane & 15) * STRIDE + 2 * u + (lane >> 4)], lane);
  } else if constexpr (W == 32) {
    x0 = transpose_lanes<32>(stage[lane * STRIDE + u], lane);
  } else {
    x0 = stage[lane * STRIDE + u];
    x1 = stage[(lane + 32) * STRIDE + u];
    transpose_lanes64(x0, x1, lane);
  }
}

// ---- 16-bit rows (every main-path stream): thread t < 256 owns words
// 32t .. 32t + 31 of the row, the encode's mapping.  It gathers its two
// plane-word columns q = 2t, 2t + 1 straight from the staged row (no
// staging buffer) and transposes them in registers (transpose16x2):
// afterwards y[r] holds word 32t + r (low half) and 32t + 16 + r (high).
__device__ __forceinline__ void gather16(const uint16_t* bm, const int* pre,
                                         int pre0, const uint16_t* pk, int t,
                                         uint32_t (&y)[16]) {
  constexpr int P = Chunk<16>::P;
  const int r = (2 * t) & 15;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int m = p * (P / 16) + (t >> 3);
    const uint32_t word = bm[m];
    const int idx = pre[m] - pre0 + (r ? __popc(word >> (16 - r)) : 0);
    const uint32_t b0 = (word >> (15 - r)) & 1u, b1 = (word >> (14 - r)) & 1u;
    const uint32_t v0 = b0 ? pk[idx] : 0u;
    const uint32_t v1 = b1 ? pk[idx + b0] : 0u;
    y[p] = v0 | (v1 << 16);
  }
  transpose16x2(y);
}

// words 2i (low) and 2i + 1 (high) of a thread's 32, from values in
// gather16's layout (v[r], v[16 + r] for the low and high halves)
__device__ __forceinline__ void store_pairs16(const uint32_t (&v)[32],
                                              int16_t* dst) {
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 8 * i + 2 * k;  // word order: 0..15 low halves, then high
      w[k] = (v[e] & 0xffffu) | (v[e + 1] << 16);
    }
    out[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The bins of a 16-bit row into `dst` (shared, word order): threads
// 0..255 gather, dezigzag and scan their 32 words; every thread of the
// CTA takes part in the block scan of the threads' sums.
__device__ __forceinline__ void bins16(unsigned char* smem, int sums_at,
                                       const uint16_t* bm, const int* pre,
                                       const uint16_t* pk, int16_t* dst) {
  const int t = threadIdx.x;
  uint32_t v[32];
  uint32_t s = 0;
  if (t < 256) {
    uint32_t y[16];
    gather16(bm, pre, 0, pk, t, y);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const uint32_t z = e < 16 ? y[e] & 0xffffu : y[e - 16] >> 16;
      s += (z >> 1) ^ (0u - (z & 1u));  // zigzag decode, wrapping sum
      v[e] = s;
    }
  }
  const uint32_t x = warp_inclusive_scan<uint32_t>(s);
  const uint32_t off = warp_offsets<uint32_t>(
      shfl(x, 31), reinterpret_cast<uint32_t*>(smem + sums_at)) + x - s;
  if (t < 256) {
#pragma unroll
    for (int e = 0; e < 32; ++e) v[e] += off;
    store_pairs16(v, dst + 32 * t);
  }
}

// The words of a 16-bit row as they are (subbins) into `dst` (shared,
// word order), by thread t of 256.
__device__ __forceinline__ void words16(const uint16_t* bm, const int* pre,
                                        int pre0, const uint16_t* pk, int t,
                                        int16_t* dst) {
  uint32_t y[16], v[32];
  gather16(bm, pre, pre0, pk, t, y);
#pragma unroll
  for (int e = 0; e < 32; ++e) v[e] = e < 16 ? y[e] : y[e - 16] >> 16;
  store_pairs16(v, dst + 32 * t);
}

// The CTA's share of the grid.
struct Work {
  long long tile;
  int c;          // bins chunk row within the tile
  long long e0;   // its first element
  int ne;         // its elements (the last row of a tile may be short)
};

__device__ __forceinline__ Work work(int nbc, int bl, int elems) {
  Work w;
  w.tile = blockIdx.x / nbc;
  w.c = blockIdx.x - (int)(w.tile * nbc);
  w.e0 = (long long)w.c * bl;
  w.ne = (int)min((long long)bl, elems - w.e0);
  return w;
}

// The bins phase: stage the row (the bitmaps already in shared memory
// and their prefix in `pre`), expand, un-transpose, dezigzag and scan.
// Calls `emit(e, bin)` for every element e < ne of the row (e relative to
// the row), from the lane that holds it, consecutive lanes on consecutive
// elements.
template <int BW, int SW, typename Emit>
__device__ __forceinline__ void decode_bins(unsigned char* smem, int ne,
                                            Emit emit) {
  using L = Layout<BW, SW>;
  using U = typename Word<BW>::U;
  using R = typename Word<BW>::R;
  constexpr int G = Chunk<BW>::G;
  constexpr int UPW = Chunk<BW>::L / G / kWarps;  // units per warp
  constexpr int V = G / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* pre = reinterpret_cast<const int*>(smem + L::PRE);
  U* stage = reinterpret_cast<U*>(smem + L::STG);
  expand<BW>(reinterpret_cast<const U*>(smem + L::BM), pre, 0,
             reinterpret_cast<const U*>(smem + L::PK_B), stage, 0,
             lg2(Chunk<BW>::P));
  __syncthreads();
  CLOCK_MARK(3);
  R val[UPW][V];
  R carry = 0;
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    R x[2];
    untranspose<BW>(stage, warp * UPW + k, x[0], x[1]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      // zigzag decode (logical shift: R is unsigned and x < 2^BW)
      const R d = (x[v] >> 1) ^ ((R)0 - (x[v] & 1u));
      const R s = warp_inclusive_scan<R>(d) + carry;
      carry = shfl(s, 31);
      val[k][v] = s;
    }
  }
  const R off = warp_offsets<R>(carry, reinterpret_cast<R*>(smem + L::SUMS));
  CLOCK_MARK(4);
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = (warp * UPW + k) * G + 32 * v + lane;
      if (e < ne) emit(e, (typename Word<BW>::S)(U)(R)(val[k][v] + off));
    }
  }
}

// Stage the bitmap rows (bins, then the subbin rows r0 .. r0 + nsr - 1),
// take their popcount prefix, then stage their packed words.
template <int BW, int SW>
__device__ __forceinline__ void stage_rows(
    unsigned char* smem, const typename Word<BW>::U* bins_bitmap,
    const typename Word<BW>::U* bins_packed, long long brow,
    const void* sub_bitmap, const void* sub_packed, long long srow, int nsr) {
  using L = Layout<BW, SW>;
  constexpr int BB = Chunk<BW>::BITMAP_BYTES;
  constexpr int SB = SW == 0 ? 0 : Chunk<SW == 0 ? 16 : SW>::BITMAP_BYTES;
  copy16(smem + L::BM, reinterpret_cast<const unsigned char*>(bins_bitmap) + brow * BB,
         BB / 16);
  if constexpr (SW != 0)
    copy16(smem + L::BM + BB,
           static_cast<const unsigned char*>(sub_bitmap) + srow * SB, nsr * SB / 16);
  cp_async_wait_all();
  __syncthreads();
  CLOCK_MARK(0);
  // popcount prefix in 16-bit units, one 32-bit word per thread
  int* pre = reinterpret_cast<int*>(smem + L::PRE);
  const int units = (BB + nsr * SB) / 2;
  const int t = threadIdx.x;
  const uint32_t w = 2 * t < units ? reinterpret_cast<const uint32_t*>(smem + L::BM)[t] : 0u;
  const int lo = __popc(w & 0xffffu), c = lo + __popc(w >> 16);
  const int x = warp_inclusive_scan<int>(c);
  const int off = warp_offsets<int>(shfl(x, 31),
                                    reinterpret_cast<int*>(smem + L::SUMS));
  if (2 * t <= L::UNITS) pre[2 * t] = off + x - c;
  if (2 * t + 1 <= L::UNITS) pre[2 * t + 1] = off + x - c + lo;
  if (t == kThreads - 1 && 2 * kThreads <= L::UNITS) pre[2 * kThreads] = off + x;
  __syncthreads();
  CLOCK_MARK(1);
  // the front-packed words of each row: as many as its bitmap has bits
  const int nb = pre[BB / 2];
  copy16(smem + L::PK_B,
         reinterpret_cast<const unsigned char*>(bins_packed) + brow * 16384,
         (nb * (BW / 8) + 15) / 16);
  if constexpr (SW != 0) {
    for (int r = 0; r < nsr; ++r) {
      const int a = pre[(BB + r * SB) / 2], n = pre[(BB + (r + 1) * SB) / 2] - a;
      copy16(smem + L::PK_S + r * 16384,
             static_cast<const unsigned char*>(sub_packed) + (srow + r) * 16384,
             (n * (SW / 8) + 15) / 16);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  CLOCK_MARK(2);
}

template <int BW, int SW, typename F>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const typename Word<BW>::U* __restrict__ bins_bitmap,
              const typename Word<BW>::U* __restrict__ bins_packed,
              const typename Word<SW>::U* __restrict__ sub_bitmap,
              const typename Word<SW>::U* __restrict__ sub_packed,
              const double* __restrict__ eps, F* __restrict__ out,
              int elems, int bins_cpt, int subs_cpt, int nbc) {
  using L = Layout<BW, SW>;
  using BS = typename Word<BW>::S;
  using SU = typename Word<SW>::U;
  using SS = typename Word<SW>::S;
  using SR = typename Word<SW>::R;
  using I = typename Ord<F>::I;
  using UI = typename Ord<F>::UI;
  constexpr int BL = Chunk<BW>::L, SL = Chunk<SW>::L, SB = Chunk<SW>::BITMAP_BYTES;
  constexpr int G = Chunk<SW>::G, V = G / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  CLOCK_START();
  const Work wk = work(nbc, BL, elems);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the subbin rows of the CTA's elements
  const long long e_end = wk.e0 + wk.ne;
  const int r0 = (int)(wk.e0 / SL), nsr = (int)((e_end - 1) / SL) - r0 + 1;
  const double tile_eps = eps[wk.tile];
  stage_rows<BW, SW>(smem, bins_bitmap, bins_packed, wk.tile * bins_cpt + wk.c,
                     sub_bitmap, sub_packed, wk.tile * subs_cpt + r0, nsr);

  // ---- bins into shared memory, in element order; 16-bit subbins too
  BS* bins = reinterpret_cast<BS*>(smem + L::BINS);
  const int* pre = reinterpret_cast<const int*>(smem + L::PRE);
  F* dst = out + wk.tile * (long long)elems;
  if constexpr (BW == 16) {
    // 16-bit subbins: threads 256..511 decode the subbin row while
    // threads 0..255 decode the bins row
    if constexpr (SW == 16) {
      if (threadIdx.x >= 256)
        words16(reinterpret_cast<const uint16_t*>(smem + L::BM + 1024),
                pre + 512, pre[512],
                reinterpret_cast<const uint16_t*>(smem + L::PK_S),
                threadIdx.x - 256, reinterpret_cast<int16_t*>(smem + L::STG));
    }
    bins16(smem, L::SUMS, reinterpret_cast<const uint16_t*>(smem + L::BM), pre,
           reinterpret_cast<const uint16_t*>(smem + L::PK_B), bins);
  } else {
    decode_bins<BW, SW>(smem, wk.ne, [&](int e, BS b) { bins[e] = b; });
  }
  __syncthreads();
  CLOCK_MARK(4);

  if constexpr (BW == 16 && SW == 16) {
    // every thread decodes elements e, e + 512, ...
    const int16_t* subs = reinterpret_cast<const int16_t*>(smem + L::STG);
    for (int e = threadIdx.x; e < wk.ne; e += kThreads) {
      const F base = Ord<F>::base((long long)bins[e], tile_eps);
      const uint64_t o = (uint64_t)(long long)Ord<F>::to_ordered(base) +
                         (uint64_t)(long long)subs[e];
      dst[wk.e0 + e] = Ord<F>::from_ordered((I)(UI)o);
    }
    CLOCK_MARK(7);
  } else {
    // ---- subbins, row by row: expand, un-transpose, decode each value
    SU* stage = reinterpret_cast<SU*>(smem + L::STG);
    // a row narrower than the CTA's: the plane words of its elements only
    constexpr int LG_NQ = lg2(SW < BW ? BL / SW : Chunk<SW>::P);
    for (int r = 0; r < nsr; ++r) {
      const long long row_e0 = (long long)(r0 + r) * SL;
      const int qa = (int)((wk.e0 > row_e0 ? wk.e0 - row_e0 : 0) / SW);
      const int u16 = (Chunk<BW>::BITMAP_BYTES + r * SB) / 2;
      expand<SW>(reinterpret_cast<const SU*>(smem + L::BM + Chunk<BW>::BITMAP_BYTES + r * SB),
                 pre + u16, pre[u16], reinterpret_cast<const SU*>(smem + L::PK_S + r * 16384),
                 stage, qa, LG_NQ);
      __syncthreads();
      CLOCK_MARK(6);
      const int units = (SW << LG_NQ) / G;
      for (int u = warp; u < units; u += kWarps) {
        SR x[2];
        untranspose<SW>(stage, u, x[0], x[1]);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const long long e = row_e0 + (long long)qa * SW + u * G + 32 * v + lane;
          if (e < e_end) {
            const long long b = (long long)bins[e - wk.e0];
            const long long sub = (long long)(SS)(SU)x[v];
            const F base = Ord<F>::base(b, tile_eps);
            const uint64_t o = (uint64_t)(long long)Ord<F>::to_ordered(base) + (uint64_t)sub;
            dst[e] = Ord<F>::from_ordered((I)(UI)o);
          }
        }
      }
      __syncthreads();  // the next row reuses the staging buffer
      CLOCK_MARK(7);
    }
  }
  CLOCK_END();
}

// No subbin stream: every value is its bin's base, through the ordered
// round trip with a zero subbin.
template <int BW, typename F>
__global__ void __launch_bounds__(kThreads)
decode_plain_kernel(const typename Word<BW>::U* __restrict__ bins_bitmap,
                    const typename Word<BW>::U* __restrict__ bins_packed,
                    const double* __restrict__ eps, F* __restrict__ out,
                    int elems, int bins_cpt, int nbc) {
  using BS = typename Word<BW>::S;
  extern __shared__ __align__(16) unsigned char smem[];
  CLOCK_START();
  const Work wk = work(nbc, Chunk<BW>::L, elems);
  const double tile_eps = eps[wk.tile];
  stage_rows<BW, 0>(smem, bins_bitmap, bins_packed, wk.tile * bins_cpt + wk.c,
                    nullptr, nullptr, 0, 0);
  F* dst = out + wk.tile * (long long)elems + wk.e0;
  if constexpr (BW == 16) {
    using L = Layout<16, 0>;
    int16_t* bins = reinterpret_cast<int16_t*>(smem + L::STG);
    bins16(smem, L::SUMS, reinterpret_cast<const uint16_t*>(smem + L::BM),
           reinterpret_cast<const int*>(smem + L::PRE),
           reinterpret_cast<const uint16_t*>(smem + L::PK_B), bins);
    __syncthreads();
    CLOCK_MARK(4);
    for (int e = threadIdx.x; e < wk.ne; e += kThreads) {
      const F base = Ord<F>::base((long long)bins[e], tile_eps);
      dst[e] = Ord<F>::from_ordered(Ord<F>::to_ordered(base));
    }
  } else {
    decode_bins<BW, 0>(smem, wk.ne, [&](int e, BS b) {
      const F base = Ord<F>::base((long long)b, tile_eps);
      dst[e] = Ord<F>::from_ordered(Ord<F>::to_ordered(base));
    });
  }
  CLOCK_MARK(5);
  CLOCK_END();
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int BW, int SW, typename F>
cudaError_t launch(const void* bbm, const void* bpk, const void* sbm,
                   const void* spk, const void* eps, void* out, int batch,
                   int elems, int bins_cpt, int subs_cpt, cudaStream_t st) {
  constexpr int smem = Layout<BW, SW>::BYTES;
  const long long nbc = (elems + Chunk<BW>::L - 1) / Chunk<BW>::L;
  if (batch * nbc > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(decode_kernel<BW, SW, F>, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<BW, SW, F><<<(unsigned)(batch * nbc), kThreads, smem, st>>>(
      static_cast<const typename Word<BW>::U*>(bbm),
      static_cast<const typename Word<BW>::U*>(bpk),
      static_cast<const typename Word<SW>::U*>(sbm),
      static_cast<const typename Word<SW>::U*>(spk),
      static_cast<const double*>(eps), static_cast<F*>(out), elems,
      bins_cpt, subs_cpt, (int)nbc);
  return cudaGetLastError();
}

template <int BW, typename F>
cudaError_t launch_sub(int sw, const void* bbm, const void* bpk,
                       const void* sbm, const void* spk, const void* eps,
                       void* out, int batch, int elems, int bcpt, int scpt,
                       cudaStream_t st) {
  switch (sw) {
    case 16: return launch<BW, 16, F>(bbm, bpk, sbm, spk, eps, out, batch, elems, bcpt, scpt, st);
    case 32: return launch<BW, 32, F>(bbm, bpk, sbm, spk, eps, out, batch, elems, bcpt, scpt, st);
    case 64: return launch<BW, 64, F>(bbm, bpk, sbm, spk, eps, out, batch, elems, bcpt, scpt, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t launch_bins(int bw, int sw, const void* bbm, const void* bpk,
                        const void* sbm, const void* spk, const void* eps,
                        void* out, int batch, int elems, int bcpt, int scpt,
                        cudaStream_t st) {
  switch (bw) {
    case 16: return launch_sub<16, F>(sw, bbm, bpk, sbm, spk, eps, out, batch, elems, bcpt, scpt, st);
    case 32: return launch_sub<32, F>(sw, bbm, bpk, sbm, spk, eps, out, batch, elems, bcpt, scpt, st);
    case 64: return launch_sub<64, F>(sw, bbm, bpk, sbm, spk, eps, out, batch, elems, bcpt, scpt, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int BW, typename F>
cudaError_t launch_plain(const void* bbm, const void* bpk, const void* eps,
                         void* out, int batch, int elems, int bins_cpt,
                         cudaStream_t st) {
  constexpr int smem = Layout<BW, 0>::BYTES;
  const long long nbc = (elems + Chunk<BW>::L - 1) / Chunk<BW>::L;
  if (batch * nbc > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(decode_plain_kernel<BW, F>, smem);
  if (err != cudaSuccess) return err;
  decode_plain_kernel<BW, F><<<(unsigned)(batch * nbc), kThreads, smem, st>>>(
      static_cast<const typename Word<BW>::U*>(bbm),
      static_cast<const typename Word<BW>::U*>(bpk),
      static_cast<const double*>(eps), static_cast<F*>(out), elems, bins_cpt,
      (int)nbc);
  return cudaGetLastError();
}

template <typename F>
cudaError_t launch_plain_bins(int bw, const void* bbm, const void* bpk,
                              const void* eps, void* out, int batch,
                              int elems, int bcpt, cudaStream_t st) {
  switch (bw) {
    case 16: return launch_plain<16, F>(bbm, bpk, eps, out, batch, elems, bcpt, st);
    case 32: return launch_plain<32, F>(bbm, bpk, eps, out, batch, elems, bcpt, st);
    case 64: return launch_plain<64, F>(bbm, bpk, eps, out, batch, elems, bcpt, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

CLOCK_EXPORTS(
    "bitmap rows load,popcount prefix,packed rows load,bins expand (W > 16),"
    "bins to shared memory (at 16 bits with the subbin row),3': values,"
    "subbin expand (W > 16),values (W > 16: with the subbin un-transpose)")

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Streams as (batch*cpt, L/W) bitmap and (batch*cpt, L) word rows; eps
// (batch,) f64; out (batch, elems) f32 (float_bits 32) or f64 (64).
int lopc_decode_tiles(const void* bins_bitmap, const void* bins_packed,
                      const void* sub_bitmap, const void* sub_packed,
                      const void* eps, void* out, long long batch,
                      long long elems, long long bins_bits,
                      long long subs_bits, long long bins_cpt,
                      long long subs_cpt, long long float_bits,
                      void* stream) {
  if (batch == 0 || elems == 0) return 0;
  if (batch > 0x7fffffffLL || elems > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int b = (int)batch, e = (int)elems, bc = (int)bins_cpt,
            sc = (int)subs_cpt, bw = (int)bins_bits, sw = (int)subs_bits;
  cudaError_t err;
  if (float_bits == 32)
    err = launch_bins<float>(bw, sw, bins_bitmap, bins_packed, sub_bitmap,
                             sub_packed, eps, out, b, e, bc, sc, st);
  else if (float_bits == 64)
    err = launch_bins<double>(bw, sw, bins_bitmap, bins_packed, sub_bitmap,
                              sub_packed, eps, out, b, e, bc, sc, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The bins stream alone (no subbin stream): as lopc_decode_tiles.
int lopc_decode_tiles_plain(const void* bins_bitmap, const void* bins_packed,
                            const void* eps, void* out, long long batch,
                            long long elems, long long bins_bits,
                            long long bins_cpt, long long float_bits,
                            void* stream) {
  if (batch == 0 || elems == 0) return 0;
  if (batch > 0x7fffffffLL || elems > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int b = (int)batch, e = (int)elems, bc = (int)bins_cpt,
            bw = (int)bins_bits;
  cudaError_t err;
  if (float_bits == 32)
    err = launch_plain_bins<float>(bw, bins_bitmap, bins_packed, eps, out, b,
                                   e, bc, st);
  else if (float_bits == 64)
    err = launch_plain_bins<double>(bw, bins_bitmap, bins_packed, eps, out, b,
                                    e, bc, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
