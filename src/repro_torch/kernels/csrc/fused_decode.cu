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
//     plus the one-ulp bump), then the ordered-int add of the subbin:
//     out = ordered_to_float(float_to_ordered(base) + sub).
// Templated on the output float (f32 with int32 ordered ints, f64 with
// int64) and on both stream word widths; the reference kernel is f32-only
// for reasons of its TPU lowering, and its f64 staged chain computes the
// same function.
//
// What bounds it on this card: bytes (the streams in, the values out);
// the arithmetic is a few integer instructions per bit.  One CTA owns one
// tile: it expands and un-transposes one 16 KiB chunk at a time in shared
// memory (the bitmap prefix popcount locates each word in the packed
// row), keeps the tile's decoded bins in shared memory, and the block-wide
// scan runs in registers and warp shuffles.  Numerics: built with
// -fmad=false; f64 division is not used; the f64 -> f32 cast is
// __double2float_rn; unsigned right shifts are logical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int W> struct Word;
template <> struct Word<16> { using S = int16_t; using U = uint16_t; using A = uint32_t; };
template <> struct Word<32> { using S = int32_t; using U = uint32_t; using A = uint32_t; };
template <> struct Word<64> { using S = int64_t; using U = uint64_t; using A = uint64_t; };

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
    const double t = ((double)bin - 0.5) * eps;
    float v = __double2float_rn(t);
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
    return ((double)bin - 0.5) * eps;
  }
};

// Shared scratch of one chunk: the expanded (still shuffled) words, the
// bitmap row and its exclusive per-word popcount prefix.
template <int W>
struct Chunk {
  static constexpr int L = 131072 / W;   // words per 16 KiB chunk
  static constexpr int P = L / W;        // bitmap words (= words per plane)
  static constexpr int K = L / kThreads; // words per thread
};

// Expand and un-transpose chunk `row` of one stream; each thread ends up
// with its K consecutive words (j = tid*K + i) in `out`.
template <int W>
__device__ void load_chunk(const typename Word<W>::U* __restrict__ bitmap,
                           const typename Word<W>::U* __restrict__ packed,
                           long long row, typename Word<W>::U* shuf,
                           typename Word<W>::U* bm, int* pre,
                           typename Word<W>::A (&out)[Chunk<W>::K]) {
  using U = typename Word<W>::U;
  using A = typename Word<W>::A;
  constexpr int L = Chunk<W>::L, P = Chunk<W>::P, K = Chunk<W>::K;
  const int tid = threadIdx.x;
  __syncthreads();  // the previous chunk's readers are done with shuf/bm
  for (int m = tid; m < P; m += kThreads) bm[m] = bitmap[row * P + m];
  __syncthreads();
  if (tid < 32) {  // exclusive prefix of the per-word popcounts (P <= 512)
    int carry = 0;
    for (int base = 0; base < P; base += 32) {
      const int m = base + tid;
      const int c = m < P ? __popcll((unsigned long long)bm[m]) : 0;
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (tid >= o) x += y;
      }
      if (m < P) pre[m] = carry + x - c;
      carry += __shfl_sync(kFull, x, 31);
    }
  }
  __syncthreads();
  const U* src = packed + row * L;
  for (int j = tid; j < L; j += kThreads) {
    const int m = j / W, r = j % W;
    const U word = bm[m];
    U v = 0;
    if ((word >> (W - 1 - r)) & 1) {
      const int above = r ? __popcll((unsigned long long)(word >> (W - r))) : 0;
      v = src[pre[m] + above];
    }
    shuf[j] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = tid * K + i;
    const int q = j / W, r = j % W;
    A w = 0;
#pragma unroll 8
    for (int p = 0; p < W; ++p) {
      const A bit = ((A)shuf[p * P + q] >> (W - 1 - r)) & 1u;
      w |= bit << (W - 1 - p);
    }
    out[i] = w;
  }
}

// Exclusive block-wide scan of one value per thread, wrapping in A.
template <typename A>
__device__ A block_exclusive_scan(A v, A* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  A x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const A y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    A s = lane < kWarps ? sums[lane] : (A)0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const A y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) sums[lane] = s;
  }
  __syncthreads();
  const A off = warp ? sums[warp - 1] : (A)0;
  __syncthreads();  // sums may be reused by the next call
  return (A)(off + x - v);
}

template <int BW, int SW, typename F>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const typename Word<BW>::U* __restrict__ bins_bitmap,
              const typename Word<BW>::U* __restrict__ bins_packed,
              const typename Word<SW>::U* __restrict__ sub_bitmap,
              const typename Word<SW>::U* __restrict__ sub_packed,
              const double* __restrict__ eps, F* __restrict__ out,
              int elems, int bins_cpt, int subs_cpt) {
  using BU = typename Word<BW>::U;
  using BS = typename Word<BW>::S;
  using BA = typename Word<BW>::A;
  using SU = typename Word<SW>::U;
  using SS = typename Word<SW>::S;
  using SA = typename Word<SW>::A;
  using I = typename Ord<F>::I;
  using UI = typename Ord<F>::UI;
  constexpr int BL = Chunk<BW>::L, BK = Chunk<BW>::K;
  constexpr int SL = Chunk<SW>::L, SK = Chunk<SW>::K;
  // dynamic shared memory: bins of the tile | shuffled chunk | bitmap row
  // | prefix | scan sums (each region aligned to 8 bytes)
  extern __shared__ __align__(16) unsigned char smem[];
  BS* bins = reinterpret_cast<BS*>(smem);
  const size_t bins_bytes = ((size_t)elems * sizeof(BS) + 15) / 16 * 16;
  unsigned char* scratch = smem + bins_bytes;
  // 16 KiB chunk, 1 KiB bitmap row at most, 2 KiB prefix, 256 B sums
  unsigned char* bm_raw = scratch + 16384;
  int* pre = reinterpret_cast<int*>(bm_raw + 1024);
  uint64_t* sums = reinterpret_cast<uint64_t*>(bm_raw + 1024 + 2048);

  const long long tile = blockIdx.x;
  const int tid = threadIdx.x;

  // ---- bins: expand, un-transpose, dezigzag, wrapping scan
  for (int c = 0; c < bins_cpt; ++c) {
    BA w[BK];
    load_chunk<BW>(bins_bitmap, bins_packed, tile * bins_cpt + c,
                   reinterpret_cast<BU*>(scratch), reinterpret_cast<BU*>(bm_raw),
                   pre, w);
    BA run = 0;
#pragma unroll
    for (int i = 0; i < BK; ++i) {
      const BA z = w[i];
      // zigzag decode (logical shift: A is unsigned and z < 2^BW)
      w[i] = (BA)((z >> 1) ^ ((BA)0 - (z & 1u)));
      run = (BA)(run + w[i]);
      w[i] = run;
    }
    const BA off = block_exclusive_scan<BA>(run, reinterpret_cast<BA*>(sums));
#pragma unroll
    for (int i = 0; i < BK; ++i) {
      const long long e = (long long)c * BL + tid * BK + i;
      if (e < elems) bins[e] = (BS)(BU)(BA)(w[i] + off);
    }
  }

  // ---- subbins: expand, un-transpose, then decode each value
  const double tile_eps = eps[tile];
  F* dst = out + tile * (long long)elems;
  for (int c = 0; c < subs_cpt; ++c) {
    SA w[SK];
    load_chunk<SW>(sub_bitmap, sub_packed, tile * subs_cpt + c,
                   reinterpret_cast<SU*>(scratch), reinterpret_cast<SU*>(bm_raw),
                   pre, w);
    // bins of this chunk were written by other threads
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SK; ++i) {
      const long long e = (long long)c * SL + tid * SK + i;
      if (e < elems) {
        const long long b = (long long)bins[e];
        const long long sub = (long long)(SS)(SU)w[i];
        const F base = Ord<F>::base(b, tile_eps);
        const uint64_t o = (uint64_t)(long long)Ord<F>::to_ordered(base) + (uint64_t)sub;
        dst[e] = Ord<F>::from_ordered((I)(UI)o);
      }
    }
  }
}

size_t smem_bytes(long long elems, int bins_word_bytes) {
  return ((size_t)elems * bins_word_bytes + 15) / 16 * 16 + 16384 + 1024 +
         2048 + 32 * sizeof(uint64_t);
}

template <int BW, int SW, typename F>
cudaError_t launch(const void* bbm, const void* bpk, const void* sbm,
                   const void* spk, const void* eps, void* out, int batch,
                   int elems, int bins_cpt, int subs_cpt, cudaStream_t st) {
  const size_t smem = smem_bytes(elems, BW / 8);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<BW, SW, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<BW, SW, F><<<batch, kThreads, smem, st>>>(
      static_cast<const typename Word<BW>::U*>(bbm),
      static_cast<const typename Word<BW>::U*>(bpk),
      static_cast<const typename Word<SW>::U*>(sbm),
      static_cast<const typename Word<SW>::U*>(spk),
      static_cast<const double*>(eps), static_cast<F*>(out), elems,
      bins_cpt, subs_cpt);
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

}  // namespace

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
  if (smem_bytes(elems, (int)(bins_bits / 8)) > 232448 - 1024 ||
      batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
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

}  // extern "C"
