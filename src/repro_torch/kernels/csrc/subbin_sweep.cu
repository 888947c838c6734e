// Tile-local subbin fixed-point solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `solve_tiles_blockwise` of
// src/repro/kernels/subbin_sweep.py (body `_make_tile_kernel`).
//
// What it computes: for each haloed int32 tile (halo held fixed), repeat
//     cur = max(cur, max_k[flag bit k](nbr_k + tie_k))
// over the 14 Freudenthal offsets as synchronous (Jacobi) sweeps until no
// interior cell changes or `max_iters` sweeps ran.  Returns the interiors
// and, per tile, the index of the last sweep that changed a cell (0 when
// the tile was already at its fixed point).  Jacobi is the reference's
// schedule, so the sweep counts match it, not only the fixed point.
//
// What bounds it on this card: the tile is re-read every sweep, so the
// work is sweeps x cells, and device memory would be read that many times
// if the state lived there.  The design keeps it out of device memory:
// one CTA owns one tile, the haloed tile lives in shared memory for all
// of its sweeps (85.5 KB for the 16x16x64 tile, 147.5 KB for the 1-D
// 1x1x4096 tile, above the 48 KB default, hence the attribute set at
// launch), and device memory is touched once to load and once to store.
// Each thread keeps its cells' flags and shared-memory indices packed in
// registers, visits only the flag bits that are set, and holds its new
// values in registers between the read phase and the write phase of a
// sweep; that register stage is the second buffer of the Jacobi scheme.
// `__syncthreads_or` is the "did anything move" test.  What remains is
// shared-memory latency and the per-sweep barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFlagBits = 14;
constexpr uint32_t kFlagMask = (1u << kFlagBits) - 1u;

// repro.core.topology.offsets(3): positive offsets sorted by (sum, o),
// then their negations.  tie = 1 exactly for the first seven.
__constant__ int kOff[14][3] = {
    {0, 0, 1}, {0, 1, 0}, {1, 0, 0}, {0, 1, 1}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
    {0, 0, -1}, {0, -1, 0}, {-1, 0, 0}, {0, -1, -1}, {-1, 0, -1}, {-1, -1, 0},
    {-1, -1, -1},
};

template <int CPT>
__global__ void __launch_bounds__(kMaxThreads)
solve_tiles_kernel(const int32_t* __restrict__ sub_h,
                   const int32_t* __restrict__ flags,
                   int32_t* __restrict__ out, int32_t* __restrict__ iters,
                   int t0, int t1, int t2, int max_iters) {
  extern __shared__ int32_t s[];
  __shared__ int delta[14];
  const int h1 = t1 + 2, h2 = t2 + 2;
  const int hsz = (t0 + 2) * h1 * h2;
  const int elems = t0 * t1 * t2;
  const int plane = t1 * t2;
  const int64_t tile = blockIdx.x;

  const int32_t* src = sub_h + tile * hsz;
  for (int i = threadIdx.x; i < hsz; i += blockDim.x) s[i] = src[i];
  if (threadIdx.x < 14) {
    const int k = threadIdx.x;
    delta[k] = (kOff[k][0] * h1 + kOff[k][1]) * h2 + kOff[k][2];
  }

  // cell[j] = (haloed index << 14) | flags; 0 marks "nothing to relax"
  uint32_t cell[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    cell[j] = 0;
    if (i < elems) {
      const uint32_t f = (uint32_t)flags[tile * elems + i] & kFlagMask;
      if (f) {
        const int a = i / plane;
        const int r = i - a * plane;
        const int b = r / t2;
        const int c = r - b * t2;
        const uint32_t h = (uint32_t)(((a + 1) * h1 + b + 1) * h2 + c + 1);
        cell[j] = (h << kFlagBits) | f;
      }
    }
  }
  __syncthreads();

  int it = 0, last = 0;
  while (true) {
    int32_t nv[CPT];
    int moved = 0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      nv[j] = 0;
      if (cell[j]) {
        const int h = (int)(cell[j] >> kFlagBits);
        uint32_t f = cell[j] & kFlagMask;
        const int32_t cur = s[h];
        int32_t m = cur;
        while (f) {
          const int k = __ffs(f) - 1;
          f &= f - 1;
          const int32_t cand = s[h + delta[k]] + (k < 7 ? 1 : 0);
          m = max(m, cand);
        }
        nv[j] = m;
        moved |= (m != cur);
      }
    }
    __syncthreads();  // every read of this sweep is done
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (cell[j]) s[cell[j] >> kFlagBits] = nv[j];
    }
    ++it;
    const int any = __syncthreads_or(moved);
    if (!any) break;
    last = it;
    if (it >= max_iters) break;
  }

  int32_t* dst = out + tile * elems;
  for (int i = threadIdx.x; i < elems; i += blockDim.x) {
    const int a = i / plane;
    const int r = i - a * plane;
    const int b = r / t2;
    const int c = r - b * t2;
    dst[i] = s[((a + 1) * h1 + b + 1) * h2 + c + 1];
  }
  if (threadIdx.x == 0) iters[tile] = last;
}

template <int CPT>
cudaError_t launch(const int32_t* sub_h, const int32_t* flags, int32_t* out,
                   int32_t* iters, int batch, int t0, int t1, int t2,
                   int max_iters, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      solve_tiles_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  solve_tiles_kernel<CPT><<<batch, threads, smem, stream>>>(
      sub_h, flags, out, iters, t0, t1, t2, max_iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lopc_errstr(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// sub_h (batch, t0+2, t1+2, t2+2) int32, flags (batch, t0, t1, t2) uint32
// bits in int32, out (batch, t0, t1, t2) int32, iters (batch,) int32.
int lopc_solve_tiles(const void* sub_h, const void* flags, void* out,
                     void* iters, long long batch, long long t0,
                     long long t1, long long t2, long long max_iters,
                     void* stream) {
  const long long elems = t0 * t1 * t2;
  const long long hsz = (t0 + 2) * (t1 + 2) * (t2 + 2);
  const size_t smem = (size_t)hsz * sizeof(int32_t);
  if (batch == 0) return 0;
  if (hsz >= (1LL << 18) || smem > 232448 - 1024)
    return (int)cudaErrorInvalidValue;
  int threads = (int)((elems + 31) / 32 * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long cpt = (elems + threads - 1) / threads;
  const int mi = (int)(max_iters < 0x7fffffff ? max_iters : 0x7fffffff);
  auto* s = static_cast<const int32_t*>(sub_h);
  auto* f = static_cast<const int32_t*>(flags);
  auto* o = static_cast<int32_t*>(out);
  auto* n = static_cast<int32_t*>(iters);
  auto st = static_cast<cudaStream_t>(stream);
  const int b = (int)batch, a0 = (int)t0, a1 = (int)t1, a2 = (int)t2;
  cudaError_t err;
  if (cpt <= 1) err = launch<1>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  else if (cpt <= 2) err = launch<2>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  else if (cpt <= 4) err = launch<4>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  else if (cpt <= 8) err = launch<8>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  else if (cpt <= 16) err = launch<16>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  else if (cpt <= 32) err = launch<32>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  else if (cpt <= 64) err = launch<64>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
