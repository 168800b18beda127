// K5: y = bf16(K) v from the upper-triangle tiles that K4 (kernel_build_sym.cu)
// stored, for v (n, t) f32, 1 <= t <= 16.
//
// Replaces the Pallas TPU kernel rbf_matvec_sym_cached /
// _make_cached_matvec_kernel of linear_operator_tpu/ops/rbf.py.
//
// Tile pair s = (i, j), j >= i, adds K_ij v_j to the rows of block i and, for
// j > i only, K_ij^T v_i to the rows of block j; a diagonal tile holds its
// whole symmetric block and adds once.
//
// What bounds it on an H100: bytes.  At n = 1e5, tile 1024 it reads the 4851
// tiles once, 1.02e10 bytes (3.04 ms at 3.35 TB/s); v and y are a few MB.  Its
// products, 2 t multiply-adds per stored entry and bf16 pass, are what a
// tensor core computes (0.45 ms at the bf16 peak for t = 11, two passes); on
// the CUDA cores, as here, they cost ~6.6 ms at 67 TFLOP/s, so this kernel
// cannot come within half of the byte bound.  A wgmma redesign is later work.
//
// The two passes in one operand.  With passes = 2, v splits into hi = bf16(v)
// and lo = bf16(v - hi), as the TPU kernel splits it; w = hi + lo is exact in
// f32 (at most 17 significant bits), and an FMA forms K w without rounding
// the product.  So one f32 FMA per entry and column computes what the TPU's
// two bf16 x bf16 -> f32 passes compute, up to summation order (and without
// their intermediate rounding).  passes = 1 takes w = hi.
//
// Design: the atomic one.  One CTA of 128 threads per (tile pair, strip of 128
// rows of the tile); 64-bit offsets into the tiles, which hold more than 2^32
// elements at n = 1e5.  The CTA walks the tile's columns in sub-blocks of 128:
//  1. the 128 x 128 bf16 sub-block is staged in shared memory (16-byte
//     streaming loads, a row pitch of 65 words against bank conflicts), with
//     w of its columns (v_j) beside w of the strip's rows (v_i, staged once);
//  2. thread c owns column c: it accumulates sum_r K[r][c] w_i[r] and adds it
//     to y with atomicAdd (off-diagonal tiles only);
//  3. thread r owns row r: it accumulates sum_c K[r][c] w_j[c] in registers
//     over all sub-blocks, and adds it to y with one atomicAdd at the end.
// y is carried transposed, (t, n), zeroed by the caller, so the atomics of a
// warp land on consecutive addresses.  Rows and columns past n (the zero
// padding of v) contribute nothing and receive nothing.  The order in which
// CTAs add to y varies from run to run: two runs differ in the last bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "covar.cuh"

namespace {

constexpr int SB = 128;           // sub-block edge, and threads per CTA
constexpr int KP = SB / 2 + 1;    // row pitch of the staged sub-block, in 32-bit words

// w = hi + lo (passes = 2) or hi (passes = 1), the bf16 parts of a, in f32
__device__ __forceinline__ float split_bf16(float a, int passes) {
  const float hi = __bfloat162float(__float2bfloat16_rn(a));
  if (passes == 1) return hi;
  return hi + __bfloat162float(__float2bfloat16_rn(a - hi));
}

// rows [row0, row0 + SB) of v (n, t) as w, zero past n and past t, into s[SB][TP]
template <int TP>
__device__ __forceinline__ void stage_v(float* s, const float* v, int row0, int n, int t, int passes) {
  for (int idx = threadIdx.x; idx < SB * TP; idx += SB) {
    const int r = idx / TP, c = idx % TP;
    s[idx] = (row0 + r < n && c < t) ? split_bf16(v[static_cast<size_t>(row0 + r) * t + c], passes) : 0.0f;
  }
}

template <int TP>
__global__ void __launch_bounds__(SB)
matvec_cached_kernel(const __nv_bfloat16* __restrict__ tiles, const int* __restrict__ imap,
                     const int* __restrict__ jmap, const float* __restrict__ v,
                     float* __restrict__ out_t, int n, int t, int tile, int passes) {
  extern __shared__ float4 smem4[];
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem4);  // SB * KP words: bf16 pairs
  float* wi = reinterpret_cast<float*>(ks + SB * KP);  // SB * TP, the strip's rows
  float* wj = wi + SB * TP;                            // SB * TP, the sub-block's columns

  const int strips = tile / SB;
  const long long pair = blockIdx.x / strips;
  const int strip = blockIdx.x % strips;
  const int bi = imap[pair], bj = jmap[pair];
  const bool off_diag = bj > bi;
  const int i0 = bi * tile + strip * SB;  // first row of the strip
  if (i0 >= n) return;                    // a strip of padding rows
  const int tid = threadIdx.x;
  const __nv_bfloat16* strip_base =
      tiles + static_cast<size_t>(pair) * tile * tile + static_cast<size_t>(strip * SB) * tile;

  stage_v<TP>(wi, v, i0, n, t, passes);
  float acc_r[TP];
#pragma unroll
  for (int c = 0; c < TP; ++c) acc_r[c] = 0.0f;

  for (int cb = 0; cb < strips; ++cb) {
    const int j0 = bj * tile + cb * SB;  // first column of the sub-block
    if (j0 >= n) break;                  // the rest of the tile is padding
    __syncthreads();                     // the previous sub-block is consumed
    stage_v<TP>(wj, v, j0, n, t, passes);
    // 16 threads per row of 128 bf16, 8 rows per pass
    for (int idx = tid; idx < SB * 16; idx += SB) {
      const int r = idx / 16, q = idx % 16;
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(strip_base + static_cast<size_t>(r) * tile +
                                                             cb * SB) + q);
      uint32_t* dst = ks + r * KP + 4 * q;
      dst[0] = u.x;
      dst[1] = u.y;
      dst[2] = u.z;
      dst[3] = u.w;
    }
    __syncthreads();

    // 2. column c = tid, over the strip's rows
    if (off_diag) {
      const int c = tid;
      float acc[TP];
#pragma unroll
      for (int k = 0; k < TP; ++k) acc[k] = 0.0f;
      const int rend = min(SB, n - i0);
      for (int r = 0; r < rend; ++r) {
        const uint32_t word = ks[r * KP + (c >> 1)];
        const float kv = __uint_as_float((c & 1) ? (word & 0xffff0000u) : (word << 16));
        axpy_row<TP>(acc, kv, wi + r * TP);
      }
      if (j0 + c < n) {
#pragma unroll
        for (int k = 0; k < TP; ++k) {
          if (k < t) atomicAdd(out_t + static_cast<size_t>(k) * n + j0 + c, acc[k]);
        }
      }
    }

    // 3. row r = tid, over the sub-block's columns
    {
      const int r = tid;
      const uint32_t* row = ks + r * KP;
      const int cend = min(SB, n - j0);
      for (int c = 0; c < cend; c += 2) {
        const uint32_t word = row[c >> 1];
        axpy_row<TP>(acc_r, __uint_as_float(word << 16), wj + c * TP);
        axpy_row<TP>(acc_r, __uint_as_float(word & 0xffff0000u), wj + (c + 1) * TP);
      }
    }
  }
  if (i0 + tid < n) {
#pragma unroll
    for (int k = 0; k < TP; ++k) {
      if (k < t) atomicAdd(out_t + static_cast<size_t>(k) * n + i0 + tid, acc_r[k]);
    }
  }
}

template <int TP>
cudaError_t launch(const __nv_bfloat16* tiles, const int* imap, const int* jmap, const float* v,
                   float* out_t, int n, int t, int tile, int npairs, int passes, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * SB * KP + sizeof(float) * 2 * SB * TP;
  auto kern = matvec_cached_kernel<TP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(static_cast<long long>(npairs) * (tile / SB));
  kern<<<grid, SB, smem, stream>>>(tiles, imap, jmap, v, out_t, n, t, tile, passes);
  return cudaGetLastError();
}

}  // namespace

// tiles (npairs, tile, tile) bf16 from kernel_build_sym_tiles; imap, jmap
// (npairs,) int32; v (n, t) f32; out_t (t, n) f32 zeroed by the caller; all
// contiguous on the device of `stream`.  1 <= t <= 16, passes 1 or 2, tile a
// positive multiple of 128, npairs (tile / 128) < 2^31.  Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int kernel_matvec_sym_cached(const void* tiles, const int* imap, const int* jmap,
                                        const float* v, float* out_t, int n, int t, int tile,
                                        int npairs, int passes, void* stream) {
  if (n < 1 || t < 1 || t > 16 || tile < SB || tile % SB != 0 || npairs < 1 ||
      (passes != 1 && passes != 2) || static_cast<long long>(npairs) * (tile / SB) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t <= 4) return launch<4>(k, imap, jmap, v, out_t, n, t, tile, npairs, passes, s);
  if (t <= 8) return launch<8>(k, imap, jmap, v, out_t, n, t, tile, npairs, passes, s);
  if (t <= 12) return launch<12>(k, imap, jmap, v, out_t, n, t, tile, npairs, passes, s);
  return launch<16>(k, imap, jmap, v, out_t, n, t, tile, npairs, passes, s);
}
