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
// registers and holds its new values in registers between the read phase
// and the write phase of a sweep; that register stage is the second
// buffer of the Jacobi scheme.  A cell's neighbour reads are unrolled
// over the 14 flag bits, with the step an immediate where the tile's dims
// are compiled in (the plan's 16x16x64 tile), so they issue together
// instead of one dependent table lookup and load at a time.
// `__syncthreads_or` is the "did anything move" test.
//
// After the first sweeps few cells move, yet a plain Jacobi sweep
// revisits every cell with a set flag bit.  The 64-bit lane's sweeps
// after the first are therefore a frontier Jacobi: a cell's new value
// can differ from its current one only if a neighbour it reads moved in
// the sweep before.  The tile's interior is cut into segments of 32
// consecutive cells (one warp's cells of one register slot, so the test
// is warp-uniform); a warp that moved cells of segment s marks, one lane
// each, the at most 28 segments holding the cells that read segment s
// (for each of the 14 offsets, the two segments 32 cells can reach), in
// a double-buffered bitmap of 64 bytes for a 16384-cell tile, and the
// next sweep recomputes only the marked segments.  The schedule stays
// synchronous, so the sweep that last changed a cell, and every value,
// are the reference's.  The marking's atomics pay only where a recompute
// is dear: on Miranda's batches on the card the frontier sped up the
// 64-bit lane's rounds after the first (8-byte states, a constraint on
// every SoS-less pair) and slowed its first less, while in the int32
// subbin lane (about one set flag bit per cell) it slowed the first
// round about as much as it sped up the later ones; so the 32-bit lanes
// run plain Jacobi sweeps.  What remains is shared-memory latency and
// the two barriers of each sweep.
//
// The int64 lane's haloed tile is 171 KB for 16x16x64 and 104.5 KB for
// 1x64x64, both within the 227 KB a block may use (one CTA per SM), but
// 295 KB for the 1-D 1x1x4096 tile.  A tile whose haloed state does not
// fit keeps only its interior in shared memory (32 KB there): each cell
// carries a mask of the set flag bits whose neighbour lies in the halo,
// and reads those neighbours from the input tile in device memory, where
// the frozen halo already is (through L1; a 1-D tile has two such
// neighbours, its Z ends).  The interiors are then read and written in
// shared memory exactly as in the haloed form.  For the 16x16x64 tile
// that form would not give two CTAs per SM: its int64 interior alone is
// 128 KB.
//
// ---- 2. Whole-field band sweep
//
// What it computes: the field's X axis is cut into 8-row bands.  One
// global sweep relaxes every band to its own least fixed point with its
// halo rows (the neighbour bands' boundary rows; the end bands read a
// clamped neighbour) frozen at the sweep-start state, and zero fill in Y
// and Z.  The TPU holds a (8+2, Y, Z) band in VMEM and iterates it there;
// at ISABEL's 500x500 plane that band is 8 MB, far beyond the 227 KB of
// shared memory an H100 block can use.
//
// What bounds it on this card: the chains.  A band's constraint chains
// wind through its whole Y x Z plane; relaxing every cell once per launch
// advances a chain one hop per launch, and every launch re-reads the
// whole field (8320 launches for one Miranda solve).  The design relaxes
// tiles of a band to convergence on chip instead: one CTA loads an
// 8 x 16 x 64 tile of one band with its halo (10 x 18 x 66 int32,
// 46.4 KB of shared memory): the Y/Z halo from the current state (zero
// fill outside the plane), the X halo rows from a snapshot of every
// band's rows 0 and 7 taken at the sweep's start.  It relaxes the tile in
// place (Gauss-Seidel: a thread's writes are read by the others within
// the same pass) until a pass moves nothing, with each cell's flags and
// shared-memory index packed in registers, then writes back the cells
// that moved and votes a change flag.  Launches repeat within a sweep
// until one moves nothing, so a sweep costs about as many launches as its
// longest chain crosses tiles, not as many as it has cells.  A launch
// relaxes only the tiles whose input may have changed: each tile stamps
// the last launch at which it moved, and a CTA returns at once unless a
// neighbour tile moved where it matters (`mode` below), so the later
// launches of a sweep touch the few tiles along the chains still moving.
//
// Why the result is the reference's: every raise is a max of current
// values that lie at or below the band's least fixed point (with the X
// halo frozen), so every value stays at or below it, whatever another CTA
// of the same launch has or has not written yet.  Only a cell's own CTA
// writes it, so values only rise.  A launch in which no CTA wrote read
// the same state everywhere and found every tile at its fixed point:
// that state is every band's least fixed point, which is unique, so the
// subbins and the global sweep count are the reference's.  The state is
// read with plain loads (not through the read-only path): other CTAs
// write it during the launch.  Each launch ORs its change flag
// (`changed[slot]`, one warp vote per warp); a launch whose predecessor's
// flag is clear returns at once, so the host queues a few launches
// between two reads of the flags.  A CTA stops after `max_passes` passes
// (`BAND_MAX_PASSES` in subbin_sweep.py, 4096), so a launch stays short
// even on a chain that winds through one whole tile: it writes back what
// moved, votes a change and sets the low bit of its stamp, and the next
// launch relaxes that tile again, whether or not a neighbour moved.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFlagBits = 14;
// a tile of at most 2^18 haloed cells has at most 2^13 segments of 32
constexpr int kNeedWords = (1 << 18) / 32 / 32;
constexpr uint32_t kFlagMask = (1u << kFlagBits) - 1u;

// repro.core.topology.offsets(3): positive offsets sorted by (sum, o),
// then their negations.  tie = 1 exactly for the first seven.
__constant__ int kOff[14][3] = {
    {0, 0, 1}, {0, 1, 0}, {1, 0, 0}, {0, 1, 1}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
    {0, 0, -1}, {0, -1, 0}, {-1, 0, 0}, {0, -1, -1}, {-1, 0, -1}, {-1, -1, 0},
    {-1, -1, -1},
};

// Haloed-index step of offset k in a tile of `plane` x `row` haloed
// cells.  Called with k a compile-time constant (an unrolled loop): with
// the tile's dims known at compile time the step is an immediate of the
// shared-memory load, so the loads of a cell's set flag bits issue
// together, without a dependent table lookup each.
__device__ __forceinline__ int hstep(int k, int plane, int row) {
  const int j = k < 7 ? k : k - 7;
  const int d = j == 0 ? 1
                : j == 1 ? row
                : j == 2 ? plane
                : j == 3 ? row + 1
                : j == 4 ? plane + 1
                : j == 5 ? plane + row
                : plane + row + 1;
  return k < 7 ? d : -d;
}

// The state's unsigned twin: the tie's +1 is added there, where wrapping
// is defined (signed overflow is not).
template <typename T> struct Unsigned;
template <> struct Unsigned<int32_t> { using type = uint32_t; };
template <> struct Unsigned<int64_t> { using type = uint64_t; };

// HALO_SMEM: the haloed tile lives in shared memory and a neighbour is
// read at s[h + step k]; SH1, SH2 > 0 fix the haloed dims t1 + 2, t2 + 2
// at compile time (the plan's 16x16x64 tile).  Otherwise only the interior lives there and a
// neighbour in the halo (bit k of the cell's halo mask) is read from the
// input in device memory, where the frozen halo already is.
template <typename T, int CPT, bool HALO_SMEM, int SH1 = 0, int SH2 = 0>
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
  // the frontier pays in the 64-bit lane only (see the note above)
  constexpr bool kFrontier = sizeof(T) == 8;
  // frontier: bit s = segment s (interior cells [32s, 32s + 32)) must be
  // recomputed; the sweep reads one buffer and marks the other
  __shared__ uint32_t need[2][kFrontier ? kNeedWords : 1];
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
  const int need_words = (elems + 1023) >> 10;
  if constexpr (kFrontier)
    for (int w = threadIdx.x; w < 2 * kNeedWords; w += blockDim.x)
      need[w / kNeedWords][w % kNeedWords] = 0;

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

  const int lane = threadIdx.x & 31;
  int it = 0, last = 0, cur_buf = 0;
  while (true) {
    T nv[CPT];
    // bit j: cell j moved in this sweep
    std::conditional_t<(CPT > 32), uint64_t, uint32_t> mv = 0;
    const uint32_t* need_cur = need[cur_buf];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      nv[j] = 0;
      const int i = threadIdx.x + j * blockDim.x;
      // sweep 1 visits every cell, later sweeps the marked segments
      if (cell[j] && (!kFrontier || it == 0 ||
                      ((need_cur[i >> 10] >> ((i >> 5) & 31)) & 1u))) {
        const int h = (int)(cell[j] >> kFlagBits);
        uint32_t f = cell[j] & kFlagMask;
        T cur;
        if constexpr (HALO_SMEM) cur = s[h];
        else cur = s[i];
        T m = cur;
        if constexpr (HALO_SMEM) {
          const int row = SH2 ? SH2 : h2, pl = SH1 ? SH1 * SH2 : h1 * h2;
#pragma unroll
          for (int k = 0; k < 14; ++k) {
            if ((f >> k) & 1u) {
              const T cand = (T)((U)s[h + hstep(k, pl, row)] + (U)(k < 7 ? 1 : 0));
              m = cand > m ? cand : m;
            }
          }
        } else {
          while (f) {
            const int k = __ffs(f) - 1;
            f &= f - 1;
            const T v = ((halo[j] >> k) & 1u) ? src[h + delta[k]]
                                              : s[i + idelta[k]];
            const T cand = (T)((U)v + (U)(k < 7 ? 1 : 0));
            m = cand > m ? cand : m;
          }
        }
        nv[j] = m;
        if (m != cur) mv |= (decltype(mv))1 << j;
      }
    }
    __syncthreads();  // every read of this sweep is done
    uint32_t* need_nxt = need[cur_buf ^ 1];
    if constexpr (kFrontier)
      for (int w = threadIdx.x; w < need_words; w += blockDim.x)
        need[cur_buf][w] = 0;
    const bool warp_moved = kFrontier && __any_sync(0xffffffffu, mv != 0);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if ((mv >> j) & 1u) {
        if constexpr (HALO_SMEM) s[cell[j] >> kFlagBits] = nv[j];
        else s[i] = nv[j];
      }
      // the warp's cells of slot j are segment i >> 5; lane l < 28 marks
      // the segment of cell 32 * (i >> 5) + (l & 1) * 31 - idelta[l / 2]
      if (warp_moved && __any_sync(0xffffffffu, (mv >> j) & 1u) && lane < 28) {
        const int pos = ((i >> 5) << 5) + (lane & 1) * 31 - idelta[lane >> 1];
        if (pos >= 0 && pos < elems)
          atomicOr(&need_nxt[pos >> 10], 1u << ((pos >> 5) & 31));
      }
    }
    cur_buf ^= 1;
    ++it;
    const int any = __syncthreads_or(mv != 0);
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

template <typename T, int CPT, bool HALO_SMEM, int SH1 = 0, int SH2 = 0>
cudaError_t launch(const T* sub_h, const int32_t* flags, T* out,
                   int32_t* iters, int batch, int t0, int t1, int t2,
                   int max_iters, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      solve_tiles_kernel<T, CPT, HALO_SMEM, SH1, SH2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  solve_tiles_kernel<T, CPT, HALO_SMEM, SH1, SH2>
      <<<batch, threads, smem, stream>>>(sub_h, flags, out, iters, t0, t1, t2,
                                         max_iters);
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

// Shared memory a block may use, less the static tables.
constexpr size_t kSmemLimit = 232448 - 3072;

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
  if (smem_halo <= kSmemLimit && t1 == 16 && t2 == 64 && threads == 1024 &&
      cpt == 16)  // the plan's 16x16x64 tile, its dims compiled in
    return (int)launch<T, 16, true, 18, 66>(s, f, o, n, b, a0, a1, a2, mi,
                                            threads, smem_halo, st);
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
constexpr int kBandTY = 16, kBandTZ = 64;  // a tile: 8 x 16 x 64 cells
constexpr int kBandH1 = kBandTY + 2, kBandH2 = kBandTZ + 2;
constexpr int kBandHsz = (kBand + 2) * kBandH1 * kBandH2;
constexpr int kBandThreads = 512;
constexpr int kBandCpt = kBand * kBandTY * kBandTZ / kBandThreads;

// Which tiles a launch relaxes (`mode`): every tile (kAll, a solve's
// first launch); at a later sweep's first launch, the tiles whose X halo
// changed, i.e. a tile of a neighbour band (clamped) at a neighbouring
// Y/Z position moved at a launch >= `since`, the previous sweep's first
// (kXHalo); at a sweep's later launches, the tiles a tile of the same
// band at a neighbouring Y/Z position moved at the launch before
// (kYZHalo), and the tile itself if the pass cap stopped it at the launch
// before.  Any other tile is still at its fixed point: its input has not
// changed since it last ran (a neighbour that moved while it ran stamped
// that launch, so it runs again).  A stamp is 2 * launch + (1 if the cap
// stopped the tile then), -1 before the tile first moved.
constexpr int kAll = 0, kXHalo = 1, kYZHalo = 2;

__global__ void __launch_bounds__(kBandThreads, 2)
band_sweep_tiles_kernel(const int32_t* __restrict__ flags, int32_t* sub,
                        const int32_t* __restrict__ snap, int32_t* stamp,
                        int32_t* changed, const int32_t* prev, int launch,
                        int mode, int since, int max_passes, int xp, int y,
                        int z, int tiles_y, int tiles_z) {
  if (prev != nullptr && *prev == 0) return;  // the bands are converged
  __shared__ int32_t s[kBandHsz];
  __shared__ int run;
  const int tz = blockIdx.x % tiles_z;
  const int ty = (blockIdx.x / tiles_z) % tiles_y;
  const int g = blockIdx.x / (tiles_z * tiles_y);
  const int bands = xp / kBand;
  if (threadIdx.x == 0) {
    int r = mode == kAll ||
            (mode == kYZHalo && stamp[blockIdx.x] == 2 * (launch - 1) + 1);
    for (int side = 0; side < 2 && !r; ++side) {
      const int nb = mode == kYZHalo ? g
                     : side ? (g + 1 < bands ? g + 1 : bands - 1)
                            : (g > 0 ? g - 1 : 0);
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          const int ny = ty + dy, nz = tz + dz;
          if (ny < 0 || ny >= tiles_y || nz < 0 || nz >= tiles_z ||
              (mode == kYZHalo && dy == 0 && dz == 0))
            continue;
          // the launch at which that tile last moved
          const int st =
              stamp[((long long)nb * tiles_y + ny) * tiles_z + nz] >> 1;
          r |= mode == kYZHalo ? st == launch - 1 : st >= since;
        }
    }
    run = r;
  }
  __syncthreads();
  if (!run) return;
  const int y0 = ty * kBandTY, z0 = tz * kBandTZ;
  const long long plane = (long long)y * z;
  const int32_t* band = sub + (long long)g * kBand * plane;
  // the X halo at the sweep start: row 7 of the band below and row 0 of
  // the band above (the end bands read their own rows, the clamp)
  const int32_t* lo = snap + ((long long)(g > 0 ? g - 1 : 0) * 2 + 1) * plane;
  const int32_t* hi =
      snap + (long long)(g + 1 < bands ? g + 1 : bands - 1) * 2 * plane;
  for (int i = threadIdx.x; i < kBandHsz; i += kBandThreads) {
    const int a = i / (kBandH1 * kBandH2);
    const int r = i - a * (kBandH1 * kBandH2);
    const int b = r / kBandH2;
    const int gy = y0 + b - 1, gz = z0 + (r - b * kBandH2) - 1;
    int32_t v = 0;  // zero fill in Y and Z
    if (gy >= 0 && gy < y && gz >= 0 && gz < z) {
      const long long yz = (long long)gy * z + gz;
      v = a == 0 ? lo[yz]
          : a == kBand + 1 ? hi[yz]
          : band[(a - 1) * plane + yz];
    }
    s[i] = v;
  }
  // cell[j] = (haloed index << 14) | flags; 0 marks "nothing to relax"
  uint32_t cell[kBandCpt];
#pragma unroll
  for (int j = 0; j < kBandCpt; ++j) {
    const int i = threadIdx.x + j * kBandThreads;
    const int a = i / (kBandTY * kBandTZ);
    const int b = (i / kBandTZ) % kBandTY;
    const int c = i % kBandTZ;
    cell[j] = 0;
    if (y0 + b < y && z0 + c < z) {
      const uint32_t f = (uint32_t)flags[(long long)g * kBand * plane +
                                         a * plane + (long long)(y0 + b) * z +
                                         z0 + c] & kFlagMask;
      if (f)
        cell[j] = ((uint32_t)(((a + 1) * kBandH1 + b + 1) * kBandH2 + c + 1)
                   << kFlagBits) | f;
    }
  }
  __syncthreads();

  uint32_t moved = 0;  // bit j: cell j moved in this launch
  int pass = 0;        // max_passes after the loop: the cap stopped it
  for (; pass < max_passes; ++pass) {
    int any = 0;
#pragma unroll
    for (int j = 0; j < kBandCpt; ++j) {
      if (!cell[j]) continue;
      const int h = (int)(cell[j] >> kFlagBits);
      const uint32_t f = cell[j] & kFlagMask;
      const int32_t c = s[h];
      int32_t m = c;
#pragma unroll
      for (int k = 0; k < 14; ++k)
        if ((f >> k) & 1u)
          m = max(m, s[h + hstep(k, kBandH1 * kBandH2, kBandH2)] +
                         (k < 7 ? 1 : 0));
      if (m != c) {
        s[h] = m;  // in place: the other threads may read it this pass
        moved |= 1u << j;
        any = 1;
      }
    }
    if (!__syncthreads_or(any)) break;
  }

#pragma unroll
  for (int j = 0; j < kBandCpt; ++j) {
    if ((moved >> j) & 1u) {
      const int i = threadIdx.x + j * kBandThreads;
      const int a = i / (kBandTY * kBandTZ);
      const int b = (i / kBandTZ) % kBandTY;
      const int c = i % kBandTZ;
      sub[(long long)g * kBand * plane + a * plane +
          (long long)(y0 + b) * z + z0 + c] =
          s[((a + 1) * kBandH1 + b + 1) * kBandH2 + c + 1];
    }
  }
  if (__syncthreads_or(moved != 0) && threadIdx.x == 0) {
    stamp[blockIdx.x] = 2 * launch + (pass == max_passes);
    changed[0] = 1;
  }
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

// flags (xp, y, z) uint32 bits in int32 (xp a multiple of 8), sub
// (xp, y, z) int32 relaxed in place, snap (xp / 8, 2, y, z) int32 rows 0
// and 7 of every band at the sweep's start, stamp (xp / 8 * ceil(y / 16)
// * ceil(z / 64),) int32 per tile 2 x the last launch at which it moved,
// plus 1 if the pass cap stopped it then (-1 before any), changed
// (>= slot + 1,) int32: the tiles `mode` selects (kAll, kXHalo after
// `since`, kYZHalo) relaxed to convergence, or for at most `max_passes`
// passes, as launch number `launch`, the change flag in changed[slot]; a
// launch with slot > 0 returns at once if changed[slot - 1] is clear.
int lopc_band_sweep(const void* flags, void* sub, const void* snap,
                    void* stamp, void* changed, long long slot,
                    long long launch, long long mode, long long since,
                    long long max_passes, long long xp, long long y,
                    long long z, void* stream) {
  const long long n = xp * y * z;
  if (n == 0) return 0;
  if (xp % kBand || slot < 0 || xp > 0x7fffffffLL || y > 0x7fffffffLL ||
      z > 0x7fffffffLL || launch < 0 || launch >= (1LL << 30) ||
      mode < kAll || mode > kYZHalo || since < -1 || since > launch ||
      max_passes < 1 || max_passes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long tiles_y = (y + kBandTY - 1) / kBandTY;
  const long long tiles_z = (z + kBandTZ - 1) / kBandTZ;
  const long long blocks = xp / kBand * tiles_y * tiles_z;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* ch = static_cast<int32_t*>(changed);
  band_sweep_tiles_kernel<<<(unsigned)blocks, kBandThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(flags), static_cast<int32_t*>(sub),
      static_cast<const int32_t*>(snap), static_cast<int32_t*>(stamp),
      ch + slot, slot > 0 ? ch + slot - 1 : nullptr, (int)launch, (int)mode,
      (int)since, (int)max_passes, (int)xp, (int)y, (int)z, (int)tiles_y,
      (int)tiles_z);
  return (int)cudaGetLastError();
}

}  // extern "C"
