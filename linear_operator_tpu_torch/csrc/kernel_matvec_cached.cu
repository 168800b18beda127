// K5: y = bf16(K) v from the upper-triangle tiles that K4 (kernel_build_sym.cu)
// stored, for v (n, t) f32, 1 <= t <= 16.
//
// Replaces the Pallas TPU kernel rbf_matvec_sym_cached /
// _make_cached_matvec_kernel of linear_operator_tpu/ops/rbf.py.
//
// Tile pair (i, j), j >= i, adds K_ij v_j to the rows of block i and, for
// j > i only, K_ij^T v_i to the rows of block j; a diagonal tile holds its
// whole symmetric block and adds once.  With passes = 2, v splits into
// hi = bf16(v) and lo = bf16(v - hi), as the TPU kernel splits it, and each
// part is one bf16 product with f32 accumulation; passes = 1 takes hi alone.
//
// What bounds it on an H100: bytes.  At n = 1e5, tile 1024 it reads the 4851
// tiles once, 1.02e10 bytes (3.04 ms at 3.35 TB/s); v and y are a few MB.  Its
// products, 2 t multiply-adds per stored entry, direction and pass, run on
// the tensor cores (mma.sync m16n8k16, bf16 -> f32): ~0.65e12 flops at t = 11,
// ~2 ms at the ~340 TFLOP/s mma.sync reaches, so they hide under the bytes.
//
// Design: a stream of 128 x 128 sub-blocks into the tensor cores.
//  - Work items are the sub-blocks (R, C) of 128-row strips R and 128-column
//    blocks C with C in a tile at or right of R's tile, in row-major order,
//    leaving out those wholly past n.  One persistent wave of CTAs (one per
//    SM) takes an equal share each, so a CTA keeps one row strip for many
//    items in a row.
//  - Staging: a ring of NSTAGE shared-memory stages, each a sub-block (row
//    pitch 272 bytes: the 8 rows an ldmatrix phase reads fall in 8 distinct
//    16-byte bank groups, with or without .trans) and the split v of its
//    columns, filled by 16-byte cp.async.cg.  NSTAGE - 1 items are in flight
//    while one is consumed: ~130 KB a SM.
//  - A prepass splits v into bf16 hi and lo B-fragment words once per launch
//    (acc3_mma.cuh's split_v_kernel), zero past n and past t.  Padded points
//    give nonzero kernel entries (K4 pads x with zeros), so only v's zeros
//    keep them out of y.
//  - Rows: warp w owns rows 16 w .. 16 w + 15 of the strip.  ldmatrix.x4
//    gives the A fragments of K, the staged words of v_C are B.  t <= 8 takes
//    one n8 block, 9-16 two.
//  - Columns (off-diagonal tiles): warp w owns columns 16 w .. 16 w + 15 of
//    the sub-block.  ldmatrix.x4.trans gives the A fragments of K^T from the
//    same shared bytes; v_R's words are B, held in registers for the strip.
//    A warp sums its columns over all 128 rows, so no cross-warp reduction
//    is needed: it turns its column sums around in shared memory and adds
//    them to y with one float4 atomicAdd per 4 columns and rhs.
//  - The tensor cores truncate when they accumulate, so each sub-block's
//    products go to fresh accumulators; the row ones are then added to the
//    strip's row sums in f32 (round to nearest), which go to y with
//    atomicAdd when the strip changes.
// y is carried transposed, (t, ldo) with ldo = n rounded up to 4 (16-byte
// aligned rows for the vector atomics), zeroed by the caller.  Offsets into the
// cache are 64-bit: it holds 5.09e9 entries at n = 1e5.  The order in which
// CTAs add to y varies from run to run: two runs differ in the last bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "acc3_mma.cuh"

namespace {

constexpr int SB = 128;                      // sub-block edge
constexpr int NW = 8;                        // warps per CTA: 16 rows and 16 columns each
constexpr int NT = 32 * NW;                  // threads per CTA
constexpr int NSTAGE = 4;                    // stages of the ring
constexpr int KPITCH = SB * 2 + 16;          // bytes of a staged sub-block row
constexpr int KBYTES = SB * KPITCH;          // bytes of a staged sub-block
constexpr int VQ = 4 * (SB / 16) + 4;        // uint4 per rhs column of a staged v (+4: conflict-free loads)
constexpr int TC = 16;                       // rhs columns, padded, at most
constexpr int CP = 16 + 4;                   // floats a rhs of a warp's column sums (+4: conflict-free stores)

inline __host__ __device__ int out_stride(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The first item of row strip r: strips of tile row block b have ns - tb b
// items each (ns strips and column blocks, tb of them a tile).
__device__ __forceinline__ long long first_item(long long r, int ns, int tb) {
  const long long b = r / tb, rr = r % tb;
  return tb * (b * ns - tb * b * (b - 1) / 2) + rr * (ns - tb * b);
}

template <int TN>
__global__ void __launch_bounds__(NT, 1)
matvec_cached_kernel(const uint16_t* __restrict__ tiles, const uint4* __restrict__ vs, float* __restrict__ out_t,
                     int n, int t, int tile, int nblk, int passes, long long nitems) {
  constexpr int TP = 8 * TN;  // rhs columns, padded
  extern __shared__ float4 smem4[];
  unsigned char* kring = reinterpret_cast<unsigned char*>(smem4);          // NSTAGE x KBYTES
  uint4* vring = reinterpret_cast<uint4*>(kring + NSTAGE * KBYTES);        // NSTAGE x TP x VQ
  float* cpart = reinterpret_cast<float*>(vring + NSTAGE * TP * VQ);       // NW x TC x CP column sums

  const int tb = tile / SB;           // sub-blocks a tile edge
  const int ns = (n + SB - 1) / SB;   // strips (and column blocks) that hold points
  const int m16 = ns * (SB / 16);     // 16-point chunks of the split v
  const int ldo = out_stride(n);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;

  // this CTA's share [i0, i1) of the items; item i0 is (r, c)
  const long long i0 = nitems * blockIdx.x / gridDim.x;
  const long long i1 = nitems * (blockIdx.x + 1) / gridDim.x;
  if (i0 >= i1) return;
  int lo = 0, hi = ns - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first_item(mid, ns, tb) <= i0) lo = mid; else hi = mid - 1;
  }
  int r = lo;
  int c = static_cast<int>((r / tb) * tb + (i0 - first_item(r, ns, tb)));

  // copies of item (rr, cc) into stage st
  auto stage = [&](int st, int rr, int cc) {
    const int bi = rr / tb, bj = cc / tb;
    const long long pair = static_cast<long long>(bi) * nblk - static_cast<long long>(bi) * (bi - 1) / 2 + (bj - bi);
    const uint16_t* src = tiles + pair * tile * static_cast<long long>(tile) +
                          static_cast<long long>(rr % tb) * SB * tile + (cc % tb) * SB;
    unsigned char* dst = kring + st * KBYTES;
    for (int idx = tid; idx < SB * 16; idx += NT) {
      const int row = idx >> 4, ch = idx & 15;
      cp_async16(dst + row * KPITCH + 16 * ch, src + static_cast<long long>(row) * tile + 8 * ch);
    }
    uint4* vdst = vring + st * TP * VQ;
    for (int idx = tid; idx < TP * 32; idx += NT) {
      const int col = idx >> 5, e = idx & 31;
      cp_async16(vdst + col * VQ + e, vs + (static_cast<size_t>(col) * m16 + 8 * cc) * 4 + e);
    }
  };

  float acc_r[TN][4];  // the strip's row sums: rows 16 warp + g (+8), rhs 8 nb + 2q (+1)
  SplitB vr[SB / 16][TN];  // v of the strip as B: rows 16 kc + 2q (+8), rhs 8 nb + g
  int cur = -1;            // the strip in the registers

  auto flush_rows = [&]() {
#pragma unroll
    for (int nb = 0; nb < TN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = cur * SB + 16 * warp + g + 8 * (e >> 1);
        const int col = 8 * nb + 2 * q + (e & 1);
        if (row < n && col < t) atomicAdd(out_t + static_cast<size_t>(col) * ldo + row, acc_r[nb][e]);
      }
  };

  auto load_strip = [&]() {
#pragma unroll
    for (int kc = 0; kc < SB / 16; ++kc)
#pragma unroll
      for (int nb = 0; nb < TN; ++nb) {
        const uint4 w = vs[(static_cast<size_t>(8 * nb + g) * m16 + r * (SB / 16) + kc) * 4 + q];
        vr[kc][nb] = {{w.x, w.y}, {w.z, w.w}};
      }
#pragma unroll
    for (int nb = 0; nb < TN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[nb][e] = 0.0f;
    cur = r;
  };

  // the item `ahead` places after (r, c), in row-major order
  auto advance = [&](int& rr, int& cc) {
    if (++cc == ns) {
      ++rr;
      cc = (rr / tb) * tb;
    }
  };

  // fill the first NSTAGE - 1 stages
  {
    int rr = r, cc = c;
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (i0 + s < i1) stage(s, rr, cc);
      cp_async_commit();
      advance(rr, cc);
    }
  }
  int pr = r, pc = c;  // the item whose copies are issued next
  for (int s = 0; s < NSTAGE - 1; ++s) advance(pr, pc);

  // lane addresses of ldmatrix: matrix lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  const unsigned row_off = (16 * warp + mr + 8 * (mi & 1)) * KPITCH + 2 * 8 * (mi >> 1);  // + 32 kc
  const unsigned col_off = (mr + 8 * (mi >> 1)) * KPITCH + 2 * (16 * warp + 8 * (mi & 1));  // + 16 kc KPITCH

  for (long long it = i0; it < i1; ++it) {
    const int st = static_cast<int>((it - i0) % NSTAGE);
    asm volatile("cp.async.wait_group %0;" ::"n"(NSTAGE - 2));
    __syncthreads();  // this item's copies have landed; the stage refilled below is consumed
    if (it + NSTAGE - 1 < i1) stage(static_cast<int>((it - i0 + NSTAGE - 1) % NSTAGE), pr, pc);
    cp_async_commit();
    advance(pr, pc);
    if (r != cur) {
      if (cur >= 0) flush_rows();
      load_strip();
    }

    const unsigned kbase = static_cast<unsigned>(__cvta_generic_to_shared(kring + st * KBYTES));
    const uint4* vb = vring + st * TP * VQ;
    const bool diag = c / tb == r / tb;

    // rows: K (strip rows 16 warp.., columns 16 kc..) times v_c
    float acc_t[TN][4];
#pragma unroll
    for (int nb = 0; nb < TN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_t[nb][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < SB / 16; ++kc) {
      uint32_t a[4];
      ldmatrix_x4(a, kbase + row_off + 32 * kc);
#pragma unroll
      for (int nb = 0; nb < TN; ++nb) {
        const uint4 w = vb[(8 * nb + g) * VQ + 4 * kc + q];
        mma_bf16(acc_t[nb], a, w.x, w.y);
        if (passes == 2) mma_bf16(acc_t[nb], a, w.z, w.w);
      }
    }
#pragma unroll
    for (int nb = 0; nb < TN; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[nb][e] += acc_t[nb][e];

    // columns: K^T (sub-block columns 16 warp.., strip rows 16 kc..) times v_r
    if (!diag) {
      float acc_c[TN][4];
#pragma unroll
      for (int nb = 0; nb < TN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_c[nb][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < SB / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, kbase + col_off + 16 * KPITCH * kc);
#pragma unroll
        for (int nb = 0; nb < TN; ++nb) {
          mma_bf16(acc_c[nb], a, vr[kc][nb].hi[0], vr[kc][nb].hi[1]);
          if (passes == 2) mma_bf16(acc_c[nb], a, vr[kc][nb].lo[0], vr[kc][nb].lo[1]);
        }
      }
      // C fragment of acc_c: rows = columns 16 warp + g (+8) of the
      // sub-block, columns = rhs 8 nb + 2q (+1); stored [rhs][column]
      float* cw = cpart + warp * TC * CP;
#pragma unroll
      for (int nb = 0; nb < TN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) cw[(8 * nb + 2 * q + (e & 1)) * CP + g + 8 * (e >> 1)] = acc_c[nb][e];
      __syncwarp();
      for (int idx = lane; idx < 4 * t; idx += 32) {
        const int rhs = idx >> 2, j4 = idx & 3;
        const int col = c * SB + 16 * warp + 4 * j4;
        if (col < n)
          atomicAdd(reinterpret_cast<float4*>(out_t + static_cast<size_t>(rhs) * ldo + col),
                    *reinterpret_cast<const float4*>(cw + rhs * CP + 4 * j4));
      }
      __syncwarp();  // the sums are read before the next item's overwrite them
    }
    advance(r, c);
  }
  if (cur >= 0) flush_rows();
}

int padded_columns(int t) { return t <= 8 ? 8 : 16; }

// points of the split v: the strips that hold points
long long padded_rows(int n) { return (static_cast<long long>(n) + SB - 1) / SB * SB; }

template <int TN>
cudaError_t launch(const uint16_t* tiles, const uint4* vs, float* out_t, int n, int t, int tile, int nblk,
                   int passes, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(NSTAGE) * (KBYTES + sizeof(uint4) * 8 * TN * VQ) + sizeof(float) * NW * TC * CP;
  auto kern = matvec_cached_kernel<TN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const int tb = tile / SB, ns = (n + SB - 1) / SB;
  // items: strips of tile row block b (tb of them, fewer in the last) have ns - tb b each
  long long nitems = 0;
  for (int r = 0; r < ns; ++r) nitems += ns - (r / tb) * tb;
  const unsigned grid = static_cast<unsigned>(nitems < sms ? nitems : sms);
  kern<<<grid, NT, smem, stream>>>(tiles, vs, out_t, n, t, tile, nblk, passes, nitems);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch that kernel_matvec_sym_cached takes for these shapes:
// v split into bf16 words.
extern "C" long long kernel_matvec_sym_cached_scratch(int n, int t) {
  if (n < 1 || t < 1 || t > 16) return -1;
  return static_cast<long long>(sizeof(uint4)) * padded_columns(t) * (padded_rows(n) / 16) * 4;
}

// tiles (npairs, tile, tile) bf16 from kernel_build_sym_tiles, in its
// row-major triangle order (pair (i, j) at i nblk - i (i - 1) / 2 + j - i);
// v (n, t) f32; out_t (t, ldo) f32 with ldo = n rounded up to a multiple of 4, zeroed
// by the caller (columns past n are scratch); scratch of
// kernel_matvec_sym_cached_scratch bytes, 16-byte aligned; all contiguous on
// the device of `stream`.  1 <= t <= 16, passes 1 or 2, tile a positive
// multiple of 128.  Returns the CUDA error of the launches (0 when they were
// accepted).
extern "C" int kernel_matvec_sym_cached(const void* tiles, const float* v, float* out_t, void* scratch, int n,
                                        int t, int tile, int npairs, int passes, void* stream) {
  const int nblk = tile >= SB ? (n + tile - 1) / tile : 0;
  if (n < 1 || t < 1 || t > 16 || tile < SB || tile % SB != 0 || (passes != 1 && passes != 2) ||
      static_cast<long long>(npairs) != static_cast<long long>(nblk) * (nblk + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tcols = padded_columns(t);
  const int m16 = static_cast<int>(padded_rows(n) / 16);
  uint4* vs = static_cast<uint4*>(scratch);
  const long long work = static_cast<long long>(m16) * 4 * tcols;
  split_v_kernel<<<static_cast<unsigned>(work / 256 + 1 < 8192 ? work / 256 + 1 : 8192), 256, 0, s>>>(
      v, vs, 1, n, t, tcols, m16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint16_t* k = static_cast<const uint16_t*>(tiles);
  if (t <= 8) return static_cast<int>(launch<1>(k, vs, out_t, n, t, tile, nblk, passes, s));
  return static_cast<int>(launch<2>(k, vs, out_t, n, t, tile, nblk, passes, s));
}
