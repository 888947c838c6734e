// Subbin fixed-point solves for Hopper (sm_90a).
//
// 1. `lopc_solve_tiles` (int32 state) and `lopc_solve_tiles64` (int64
//    state) replace the Pallas TPU kernel `solve_tiles_blockwise` of
//    src/repro/kernels/subbin_sweep.py (body `_make_tile_kernel`): the
//    tiled engine's solve.
// 2. `lopc_band_sweep` replaces the Pallas TPU kernel `solve_blockwise`
//    of the same file (`_one_global_sweep`, `_sweep_kernel`,
//    `_relax_band`): the whole-field solve of the v1 compressor.
//
// ---- 1. Tile-local solve
//
// What it computes: for each haloed tile (halo held fixed), repeat
//     cur = max(cur, max_k[flag bit k](nbr_k + tie_k))
// over the 14 Freudenthal offsets as synchronous (Jacobi) sweeps until no
// interior cell changes or `max_iters` sweeps ran.  Returns the interiors
// and, per tile, the index of the last sweep that changed a cell (0 when
// the tile was already at its fixed point).  Jacobi is the reference's
// schedule, so the sweep counts match it, not only the fixed point.
//
// Two lanes.  The subbin lane (order-preserving compress) carries int32
// subbins >= 0.  The ordered-space lane (adaptive error bounds) carries
// each cell's decoded value as an ordered int: the reference holds it
// biased and unsigned (uint32 for f32 fields, uint64 for f64, 0 the
// neutral fill); here it is the signed ordered int itself, its twin
// under the order-preserving bijection u = s + 2^(w-1) mod 2^w, which
// commutes with the tie's +1, so the fixed point, the sweep counts and
// the stored differences are the same bits, and INT_MIN stands for the
// unsigned 0.  The kernel maxes only over set flag bits, so it never
// reads a neutral or fill value that no set bit points at.  The f32 lane
// runs the int32 instantiation, the f64 lane the int64 one; the +1 is
// added in the unsigned twin, where wrapping is defined.
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
//
// The int64 lane's haloed tile is 171 KB for 16x16x64 and 104.5 KB for
// 1x64x64, both within the 227 KB a block may use (one CTA per SM), but
// 295 KB for the 1-D 1x1x4096 tile.  A tile whose haloed state does not
// fit keeps only its interior in shared memory (32 KB there): each cell
// carries a mask of the set flag bits whose neighbour lies in the halo,
// and reads those neighbours from the input tile in device memory, where
// the frozen halo already is (through L1; a 1-D tile has two such
// neighbours, its Z ends).  The interiors are then read and written in
// shared memory exactly as in the haloed form.
//
// ---- 2. Whole-field band sweep
//
// What it computes: the field's X axis is cut into 8-row bands.  One
// global sweep relaxes every band to its own least fixed point with its
// halo rows (the neighbour bands' boundary rows; the end bands read a
// clamped neighbour) frozen at the sweep-start state, and zero fill in Y
// and Z.  The TPU holds a (8+2, Y, Z) band in VMEM and iterates it there;
// at ISABEL's 500x500 plane that band is 8 MB, far beyond the 227 KB of
// shared memory an H100 block can use, so the band lives in device
// memory.  One launch relaxes every cell once: neighbours in the cell's
// own band come from the current state (`cur`, written to `nxt`, the two
// ping-ponged by the host), neighbours in another band (or past either
// end of X) from the sweep-start snapshot `snap`.  Launches repeat until
// one changes nothing: that is every band's fixed point, which is unique,
// so the result and the global sweep count are the reference's.  Each
// launch ORs its own change flag (`changed[slot]`, one warp vote per
// warp); a launch whose predecessor's flag is clear returns at once, so
// the host can queue several launches between two reads of the flags.
//
// What bounds it on this card: bytes.  A launch reads the flags and the
// state once per cell (neighbours mostly hit L1/L2) and writes the state
// once; the host repeats it as many times as the band relaxation needs.

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

// The state's unsigned twin: the tie's +1 is added there, where wrapping
// is defined (signed overflow is not).
template <typename T> struct Unsigned;
template <> struct Unsigned<int32_t> { using type = uint32_t; };
template <> struct Unsigned<int64_t> { using type = uint64_t; };

// HALO_SMEM: the haloed tile lives in shared memory and a neighbour is
// read at s[h + delta[k]].  Otherwise only the interior lives there and a
// neighbour in the halo (bit k of the cell's halo mask) is read from the
// input in device memory, where the frozen halo already is.
template <typename T, int CPT, bool HALO_SMEM>
__global__ void __launch_bounds__(kMaxThreads)
solve_tiles_kernel(const T* __restrict__ sub_h,
                   const int32_t* __restrict__ flags,
                   T* __restrict__ out, int32_t* __restrict__ iters,
                   int t0, int t1, int t2, int max_iters) {
  using U = typename Unsigned<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  __shared__ int delta[14];   // haloed-index step of offset k
  __shared__ int idelta[14];  // interior-index step of offset k
  const int h1 = t1 + 2, h2 = t2 + 2;
  const int hsz = (t0 + 2) * h1 * h2;
  const int elems = t0 * t1 * t2;
  const int plane = t1 * t2;
  const int64_t tile = blockIdx.x;

  const T* src = sub_h + tile * hsz;
  if constexpr (HALO_SMEM) {
    for (int i = threadIdx.x; i < hsz; i += blockDim.x) s[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < elems; i += blockDim.x) {
      const int a = i / plane;
      const int r = i - a * plane;
      const int b = r / t2;
      s[i] = src[((a + 1) * h1 + b + 1) * h2 + (r - b * t2) + 1];
    }
  }
  if (threadIdx.x < 14) {
    const int k = threadIdx.x;
    delta[k] = (kOff[k][0] * h1 + kOff[k][1]) * h2 + kOff[k][2];
    idelta[k] = (kOff[k][0] * t1 + kOff[k][1]) * t2 + kOff[k][2];
  }

  // cell[j] = (haloed index << 14) | flags; 0 marks "nothing to relax";
  // halo[j]: the set flag bits whose neighbour lies in the halo
  uint32_t cell[CPT];
  uint32_t halo[HALO_SMEM ? 1 : CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    cell[j] = 0;
    if constexpr (!HALO_SMEM) halo[j] = 0;
    if (i < elems) {
      const uint32_t f = (uint32_t)flags[tile * elems + i] & kFlagMask;
      if (f) {
        const int a = i / plane;
        const int r = i - a * plane;
        const int b = r / t2;
        const int c = r - b * t2;
        const uint32_t h = (uint32_t)(((a + 1) * h1 + b + 1) * h2 + c + 1);
        cell[j] = (h << kFlagBits) | f;
        if constexpr (!HALO_SMEM) {
          for (int k = 0; k < 14; ++k) {
            const int na = a + kOff[k][0], nb = b + kOff[k][1],
                      nc = c + kOff[k][2];
            if (na < 0 || na >= t0 || nb < 0 || nb >= t1 || nc < 0 ||
                nc >= t2)
              halo[j] |= 1u << k;
          }
          halo[j] &= f;
        }
      }
    }
  }
  __syncthreads();

  int it = 0, last = 0;
  while (true) {
    T nv[CPT];
    int moved = 0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      nv[j] = 0;
      if (cell[j]) {
        const int h = (int)(cell[j] >> kFlagBits);
        const int i = threadIdx.x + j * blockDim.x;
        uint32_t f = cell[j] & kFlagMask;
        T cur;
        if constexpr (HALO_SMEM) cur = s[h];
        else cur = s[i];
        T m = cur;
        while (f) {
          const int k = __ffs(f) - 1;
          f &= f - 1;
          T v;
          if constexpr (HALO_SMEM) v = s[h + delta[k]];
          else v = ((halo[j] >> k) & 1u) ? src[h + delta[k]] : s[i + idelta[k]];
          const T cand = (T)((U)v + (U)(k < 7 ? 1 : 0));
          m = cand > m ? cand : m;
        }
        nv[j] = m;
        moved |= (m != cur);
      }
    }
    __syncthreads();  // every read of this sweep is done
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (cell[j]) {
        if constexpr (HALO_SMEM) s[cell[j] >> kFlagBits] = nv[j];
        else s[threadIdx.x + j * blockDim.x] = nv[j];
      }
    }
    ++it;
    const int any = __syncthreads_or(moved);
    if (!any) break;
    last = it;
    if (it >= max_iters) break;
  }

  T* dst = out + tile * elems;
  for (int i = threadIdx.x; i < elems; i += blockDim.x) {
    if constexpr (HALO_SMEM) {
      const int a = i / plane;
      const int r = i - a * plane;
      const int b = r / t2;
      const int c = r - b * t2;
      dst[i] = s[((a + 1) * h1 + b + 1) * h2 + c + 1];
    } else {
      dst[i] = s[i];
    }
  }
  if (threadIdx.x == 0) iters[tile] = last;
}

template <typename T, int CPT, bool HALO_SMEM>
cudaError_t launch(const T* sub_h, const int32_t* flags, T* out,
                   int32_t* iters, int batch, int t0, int t1, int t2,
                   int max_iters, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      solve_tiles_kernel<T, CPT, HALO_SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  solve_tiles_kernel<T, CPT, HALO_SMEM><<<batch, threads, smem, stream>>>(
      sub_h, flags, out, iters, t0, t1, t2, max_iters);
  return cudaGetLastError();
}

template <typename T, bool HALO_SMEM>
cudaError_t launch_cpt(long long cpt, const T* s, const int32_t* f, T* o,
                       int32_t* n, int b, int a0, int a1, int a2, int mi,
                       int threads, size_t smem, cudaStream_t st) {
  if (cpt <= 1) return launch<T, 1, HALO_SMEM>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  if (cpt <= 2) return launch<T, 2, HALO_SMEM>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  if (cpt <= 4) return launch<T, 4, HALO_SMEM>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  if (cpt <= 8) return launch<T, 8, HALO_SMEM>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  if (cpt <= 16) return launch<T, 16, HALO_SMEM>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  if (cpt <= 32) return launch<T, 32, HALO_SMEM>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  if (cpt <= 64) return launch<T, 64, HALO_SMEM>(s, f, o, n, b, a0, a1, a2, mi, threads, smem, st);
  return cudaErrorInvalidValue;
}

// Shared memory a block may use, less the static delta tables.
constexpr size_t kSmemLimit = 232448 - 1024;

template <typename T>
int solve_tiles(const void* sub_h, const void* flags, void* out, void* iters,
                long long batch, long long t0, long long t1, long long t2,
                long long max_iters, void* stream) {
  const long long elems = t0 * t1 * t2;
  const long long hsz = (t0 + 2) * (t1 + 2) * (t2 + 2);
  if (batch == 0) return 0;
  if (hsz >= (1LL << 18)) return (int)cudaErrorInvalidValue;
  const size_t smem_halo = (size_t)hsz * sizeof(T);
  const size_t smem_int = (size_t)elems * sizeof(T);
  int threads = (int)((elems + 31) / 32 * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long cpt = (elems + threads - 1) / threads;
  const int mi = (int)(max_iters < 0x7fffffff ? max_iters : 0x7fffffff);
  auto* s = static_cast<const T*>(sub_h);
  auto* f = static_cast<const int32_t*>(flags);
  auto* o = static_cast<T*>(out);
  auto* n = static_cast<int32_t*>(iters);
  auto st = static_cast<cudaStream_t>(stream);
  const int b = (int)batch, a0 = (int)t0, a1 = (int)t1, a2 = (int)t2;
  if (smem_halo <= kSmemLimit)
    return (int)launch_cpt<T, true>(cpt, s, f, o, n, b, a0, a1, a2, mi,
                                    threads, smem_halo, st);
  // int32 tiles of the plan always fit with their halo
  if constexpr (sizeof(T) == 8) {
    if (smem_int <= kSmemLimit)
      return (int)launch_cpt<T, false>(cpt, s, f, o, n, b, a0, a1, a2, mi,
                                       threads, smem_int, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- 2. whole-field band sweep

constexpr int kBand = 8;
constexpr int kBandThreads = 256;

__global__ void __launch_bounds__(kBandThreads)
band_sweep_kernel(const int32_t* __restrict__ flags, const int32_t* cur,
                  const int32_t* snap, int32_t* nxt, int32_t* changed,
                  const int32_t* prev, long long n, int xp, int y, int z) {
  if (prev != nullptr && *prev == 0) return;  // the bands are converged
  const long long i = (long long)blockIdx.x * kBandThreads + threadIdx.x;
  int moved = 0;
  if (i < n) {
    uint32_t f = (uint32_t)flags[i] & kFlagMask;
    const int32_t c = cur[i];
    int32_t m = c;
    if (f) {
      const long long plane = (long long)y * z;
      const int a = (int)(i / plane);
      const int r = (int)(i - (long long)a * plane);
      const int b = r / z;
      const int cz = r - b * z;
      const int band = a / kBand;
      while (f) {
        const int k = __ffs(f) - 1;
        f &= f - 1;
        int na = a + kOff[k][0];
        const int nb = b + kOff[k][1];
        const int nc = cz + kOff[k][2];
        int32_t v = 0;  // zero fill in Y and Z
        if (nb >= 0 && nb < y && nc >= 0 && nc < z) {
          if (na < 0) na = kBand - 1;        // band 0's clamped neighbour
          else if (na >= xp) na = xp - kBand;  // the last band's
          const bool halo = na / kBand != band || a + kOff[k][0] != na;
          const long long j = ((long long)na * y + nb) * z + nc;
          v = halo ? snap[j] : cur[j];
        }
        m = max(m, v + (k < 7 ? 1 : 0));
      }
      moved = m != c;
    }
    nxt[i] = m;
  }
  if (__any_sync(0xffffffffu, moved) && (threadIdx.x & 31) == 0)
    changed[0] = 1;
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
  return solve_tiles<int32_t>(sub_h, flags, out, iters, batch, t0, t1, t2,
                              max_iters, stream);
}

// The same with an int64 state: sub_h and out int64.
int lopc_solve_tiles64(const void* sub_h, const void* flags, void* out,
                       void* iters, long long batch, long long t0,
                       long long t1, long long t2, long long max_iters,
                       void* stream) {
  return solve_tiles<int64_t>(sub_h, flags, out, iters, batch, t0, t1, t2,
                              max_iters, stream);
}

// flags (xp, y, z) uint32 bits in int32 (xp a multiple of 8), cur, snap,
// nxt (xp, y, z) int32, changed (>= slot + 1,) int32: one relaxation of
// every cell, the change flag of launch `slot` in changed[slot]; a launch
// with slot > 0 returns at once if changed[slot - 1] is clear.
int lopc_band_sweep(const void* flags, const void* cur, const void* snap,
                    void* nxt, void* changed, long long slot, long long xp,
                    long long y, long long z, void* stream) {
  const long long n = xp * y * z;
  if (n == 0) return 0;
  if (xp % kBand || slot < 0 || xp > 0x7fffffffLL || y > 0x7fffffffLL ||
      z > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto* ch = static_cast<int32_t*>(changed);
  const long long blocks = (n + kBandThreads - 1) / kBandThreads;
  band_sweep_kernel<<<(unsigned)blocks, kBandThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flags), static_cast<const int32_t*>(cur),
      static_cast<const int32_t*>(snap), static_cast<int32_t*>(nxt),
      ch + slot, slot > 0 ? ch + slot - 1 : nullptr, n, (int)xp, (int)y,
      (int)z);
  return (int)cudaGetLastError();
}

}  // extern "C"
