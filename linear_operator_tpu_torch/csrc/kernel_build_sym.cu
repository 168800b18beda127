// K4: the bf16 upper-triangle tiles of the stationary kernel matrix
// K_ij = k(|x_i - x_j|^2), for the cached mat-vec K5 (kernel_matvec_cached.cu).
//
// Replaces the Pallas TPU kernel rbf_build_sym_tiles / _make_sym_build_kernel
// of linear_operator_tpu/ops/rbf.py.
//
// Output: tiles (npairs, tile, tile) bf16 with nblk = ceil(n / tile) and
// npairs = nblk (nblk + 1) / 2; pair s is the s-th tile pair (i, j), j >= i,
// in row-major triangle order (i outer, j ascending); entry (r, c) of pair s
// is k(x[i tile + r], x[j tile + c]), x zero-padded past n.
//
// What bounds it on an H100: bytes.  At n = 1e5, tile 1024 it writes 4851
// tiles of 2 MiB, 1.02e10 bytes (3.04 ms at 3.35 TB/s); the inputs are 1.2 MB.
// Its 5.1e9 entries cost ~11 instructions each on the CUDA cores (~1.7 ms of
// issue at 132 SMs x 4 schedulers) and one ex2 on the special-function units
// (~1.2 ms at 16 per SM and clock), so the arithmetic fits under the stores
// only if the two overlap.
//
// Design.
//  - Work items are sub-blocks of R x C = 16384 entries (32 KiB) of one tile
//    pair, ordered (pair, band of R rows, block of C columns); C is 1024 or
//    the widest of 512, 256, 128 that divides the tile, so at tile 1024 an
//    item is 16 whole tile rows, one contiguous 32 KiB of the cache.  One
//    persistent wave of CTAs, each walking an equal contiguous share.
//  - A prepass (acc3_mma.cuh) pads x to whole tiles of 16-byte rows (4 or 8
//    floats, or d rounded up to 4) with the squared norms, so that a thread
//    reads a point with aligned float4 loads and no bounds checks.
//  - Each of the 256 threads owns 8 consecutive columns (their points in
//    registers, reloaded only when the column block changes: once per tile
//    pair at C = tile) and 8 rows (each row point read when its row is
//    formed, from L1).
//  - Stores: each row's 8 entries are packed with cvt.rn.bf16x2.f32 into one
//    16-byte word and stored straight from registers with st.global.cs (a
//    warp writes 512 contiguous bytes, whole cache lines, and goes on
//    forming; the memory system keeps the stores of the wave's warps in
//    flight).  The formation alone takes ~2.5 ms and the stores alone ~3.2,
//    and the two overlap.  The other way, each item staged in shared memory
//    and handed to the bulk-copy engine (cp.async.bulk shared -> global)
//    while the next is formed, measured ~0.2 ms slower (kernel_variants.py,
//    variant bulk_store, which holds its code).
//  - The exponent: covar_fast (acc3_mma.cuh), one ex2.approx with the RBF's
//    -1/2 log2(e) in one multiply and subnormal results kept by squaring
//    2^(y/2); the tiles stay within one bf16 ulp of the plain version's, at
//    least 99.9% bit-identical (the tests' bound).
//
// Distances: d <= 8 sums the squared differences over d zero-padded to DS =
// 3, 4 or 8, in the order and with the separate roundings of the plain
// version (ops/rbf.py sq_dist: d2 = e0 e0, then d2 + ek ek; no FMA
// contraction), so the f32 distances agree bit for bit; d > 8 (DS = 0) takes
// the quadratic form (sq_i + sq_j) - 2 x_i.x_j, clamped at 0, its inner
// product in one fixed FMA order (k ascending, as the squared norms), read in
// chunks of 4 dimensions, so any d fits and a point's distance to itself is
// exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "acc3_mma.cuh"

namespace {

constexpr int SB = 128;                    // the tile is a multiple of this
constexpr int NT = 256;                    // threads per CTA
constexpr int CPT = 8;                     // columns per thread: one 16-byte word of bf16
constexpr int RPT = 8;                     // rows per thread
constexpr int ITEM = 16384;                // entries of a work item, R x C

__device__ __forceinline__ void st_global_cs(void* p, const uint4& w) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
               : "memory");
}

// Squared distance over DS dimensions in the plain version's order and
// roundings: d2 = e0 e0, then d2 + ek ek.
template <int DS>
__device__ __forceinline__ float exact_d2(const float* a, const float* b) {
  float diff = __fsub_rn(a[0], b[0]);
  float d2 = __fmul_rn(diff, diff);
#pragma unroll
  for (int k = 1; k < DS; ++k) {
    diff = __fsub_rn(a[k], b[k]);
    d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
  }
  return d2;
}

// The first DS floats of padded point p (rows of DP floats), by float4 loads.
template <int DS, int DP>
__device__ __forceinline__ void load_dims(float (&a)[DS], const float* xp, long long p) {
  float w[DP];
  load_point<DP>(w, xp, static_cast<int>(p));
#pragma unroll
  for (int k = 0; k < DS; ++k) a[k] = w[k];
}

// 8 entries as one 16-byte word of bf16, round to nearest even
__device__ __forceinline__ uint4 pack8(const float (&e)[CPT]) {
  return make_uint4(pack_bf16x2(e[0], e[1]), pack_bf16x2(e[2], e[3]), pack_bf16x2(e[4], e[5]),
                    pack_bf16x2(e[6], e[7]));
}

// DS: dimensions of the exact distance (3, 4 or 8, zero-padded past d); 0
// takes the quadratic form (d > 8) over dx (d rounded up to 4) dimensions.
// cols: C, the columns of a work item (R = ITEM / C rows).
template <int COVAR, int DS>
__global__ void __launch_bounds__(NT, DS > 0 && DS <= 4 ? 2 : 1)
build_sym_tiles_kernel(const float* __restrict__ xp, const float* __restrict__ sq, __nv_bfloat16* __restrict__ tiles,
                       int dx, int tile, int nblk, int cols, long long items, float alpha) {
  constexpr int DP = DS == 8 ? 8 : 4;  // floats of a padded point (DS > 0)
  const int rows = ITEM / cols, bands = tile / rows, blocks = tile / cols;
  const long long per_pair = static_cast<long long>(bands) * blocks;
  // thread layout: column group cg (8 columns), rows rg + step k
  const int groups = cols / CPT, step = NT / groups;
  const int tid = threadIdx.x, cg = tid % groups, rg = tid / groups, c0 = CPT * cg;

  // this CTA's share [p0, p1) of the work items (pair, band, block)
  const long long p0 = items * blockIdx.x / gridDim.x;
  const long long p1 = items * (blockIdx.x + 1) / gridDim.x;
  long long pair = p0 / per_pair;
  int band = static_cast<int>(p0 % per_pair) / blocks, blk = static_cast<int>(p0 % per_pair) % blocks;
  // the pair's tile row bi and column bj: the last row whose first pair is <= pair
  auto first_pair = [nblk](long long r) { return r * nblk - r * (r - 1) / 2; };
  int lo = 0, hi = nblk - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first_pair(mid) <= pair) lo = mid; else hi = mid - 1;
  }
  int bi = lo;
  int bj = bi + static_cast<int>(pair - first_pair(bi));

  float xc[CPT][DS > 0 ? DS : 1];  // DS > 0: the points of the thread's columns
  long long jcur = -1;             // and the first column point they belong to
  for (long long p = p0; p < p1; ++p) {
    const long long i0 = static_cast<long long>(bi) * tile + band * rows;  // padded index of the first row point
    const long long j0 = static_cast<long long>(bj) * tile + blk * cols;   // and of the first column point
    __nv_bfloat16* gbase =
        tiles + static_cast<size_t>(pair) * tile * tile + static_cast<size_t>(band * rows) * tile + blk * cols;

    // the word of row r, straight to the cache
    auto emit = [&](int r, const uint4& w) { st_global_cs(gbase + static_cast<size_t>(r) * tile + c0, w); };

    if constexpr (DS > 0) {
      if (j0 != jcur) {
#pragma unroll
        for (int q = 0; q < CPT; ++q) load_dims<DS, DP>(xc[q], xp, j0 + c0 + q);
        jcur = j0;
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = rg + step * k;
        float xr[DS];
        load_dims<DS, DP>(xr, xp, i0 + r);
        float e[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q) e[q] = covar_fast<COVAR, false>(exact_d2<DS>(xr, xc[q]), alpha);
        emit(r, pack8(e));
      }
    } else {
      float inner[RPT][CPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k)
#pragma unroll
        for (int q = 0; q < CPT; ++q) inner[k][q] = 0.0f;
      for (int c = 0; c < dx; c += 4) {
        float4 a[RPT], b[CPT];
#pragma unroll
        for (int k = 0; k < RPT; ++k)
          a[k] = *reinterpret_cast<const float4*>(xp + static_cast<size_t>(i0 + rg + step * k) * dx + c);
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          b[q] = *reinterpret_cast<const float4*>(xp + static_cast<size_t>(j0 + c0 + q) * dx + c);
#pragma unroll
        for (int k = 0; k < RPT; ++k)
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            float s = inner[k][q];
            s = fmaf(a[k].x, b[q].x, s);
            s = fmaf(a[k].y, b[q].y, s);
            s = fmaf(a[k].z, b[q].z, s);
            inner[k][q] = fmaf(a[k].w, b[q].w, s);
          }
      }
      float sqc[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) sqc[q] = sq[j0 + c0 + q];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = rg + step * k;
        const float sqr = sq[i0 + r];
        float e[CPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const float d2 = fmaxf(__fsub_rn(__fadd_rn(sqr, sqc[q]), __fmul_rn(2.0f, inner[k][q])), 0.0f);
          e[q] = covar_fast<COVAR, false>(d2, alpha);
        }
        emit(r, pack8(e));
      }
    }

    if (++blk == blocks) {
      blk = 0;
      if (++band == bands) {
        band = 0;
        ++pair;
        if (++bj == nblk) bj = ++bi;
      }
    }
  }
}

// C, the columns of a work item: 1024, or the widest of 512, 256 and 128
// that divides the tile
int item_columns(int tile) {
  int cols = SB;
  while (cols * 2 <= 1024 && tile % (cols * 2) == 0) cols *= 2;
  return cols;
}

template <int COVAR, int DS>
cudaError_t launch(const float* xp, const float* sq, __nv_bfloat16* tiles, int dx, int tile, int nblk, float alpha,
                   cudaStream_t stream) {
  auto kern = build_sym_tiles_kernel<COVAR, DS>;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, 0)) != cudaSuccess) return err;
  const int cols = item_columns(tile);
  const long long items = static_cast<long long>(nblk) * (nblk + 1) / 2 * (tile / (ITEM / cols)) * (tile / cols);
  // one wave: each CTA takes an equal share of the work items
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(items < wave ? items : wave);
  kern<<<grid, NT, 0, stream>>>(xp, sq, tiles, dx, tile, nblk, cols, items, alpha);
  return cudaGetLastError();
}

template <int COVAR>
cudaError_t by_dims(const float* xp, const float* sq, __nv_bfloat16* tiles, int d, int dx, int tile, int nblk,
                    float alpha, cudaStream_t stream) {
  if (d <= 3) return launch<COVAR, 3>(xp, sq, tiles, dx, tile, nblk, alpha, stream);
  if (d <= 4) return launch<COVAR, 4>(xp, sq, tiles, dx, tile, nblk, alpha, stream);
  if (d <= 8) return launch<COVAR, 8>(xp, sq, tiles, dx, tile, nblk, alpha, stream);
  return launch<COVAR, 0>(xp, sq, tiles, dx, tile, nblk, alpha, stream);
}

bool valid(int n, int d, int tile) { return n >= 1 && d >= 1 && tile >= SB && tile % SB == 0; }

// points padded to whole tiles
long long padded_n(int n, int tile) { return (static_cast<long long>(n) + tile - 1) / tile * tile; }

}  // namespace

// Bytes of the scratch that kernel_build_sym_tiles takes for these shapes.
extern "C" long long kernel_build_sym_tiles_scratch(int n, int d, int tile) {
  if (!valid(n, d, tile)) return -1;
  return static_cast<long long>(sizeof(float)) * padded_n(n, tile) * (padded_dim(d) + 1);
}

// x (n, d) f32; tiles (npairs, tile, tile) bf16 with nblk = ceil(n / tile),
// npairs = nblk (nblk + 1) / 2; scratch of kernel_build_sym_tiles_scratch
// bytes (16-byte aligned); all contiguous on the device of `stream`.  tile a
// positive multiple of 128, d >= 1.  Returns the CUDA error of the launches
// (0 when they were accepted).
extern "C" int kernel_build_sym_tiles(const float* x, void* tiles, void* scratch, int n, int d, int tile, int covar,
                                      float alpha, void* stream) {
  if (!valid(n, d, tile) || covar < 0 || covar >= NUM_COVARS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npad = padded_n(n, tile);
  const int nblk = static_cast<int>(npad / tile), dx = padded_dim(d);
  float* xp = static_cast<float*>(scratch);
  float* sq = xp + npad * dx;
  const int threads = 256;
  const long long blocks = npad / threads + 1 < 8192 ? npad / threads + 1 : 8192;
  pad_points_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(x, xp, sq, 1, n, d, static_cast<int>(npad), dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(tiles);
  switch (covar) {
    case COVAR_RBF: return by_dims<COVAR_RBF>(xp, sq, out, d, dx, tile, nblk, alpha, s);
    case COVAR_MATERN52: return by_dims<COVAR_MATERN52>(xp, sq, out, d, dx, tile, nblk, alpha, s);
    case COVAR_MATERN32: return by_dims<COVAR_MATERN32>(xp, sq, out, d, dx, tile, nblk, alpha, s);
    case COVAR_MATERN12: return by_dims<COVAR_MATERN12>(xp, sq, out, d, dx, tile, nblk, alpha, s);
#ifdef LO_USER_COVAR
    case COVAR_USER: return by_dims<COVAR_USER>(xp, sq, out, d, dx, tile, nblk, alpha, s);
#endif
    default: return by_dims<COVAR_RQ>(xp, sq, out, d, dx, tile, nblk, alpha, s);
  }
}
