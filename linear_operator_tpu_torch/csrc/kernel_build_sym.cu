// K4: the bf16 upper-triangle tiles of the stationary kernel matrix
// K_ij = k(|x_i - x_j|^2), for the cached mat-vec K5 (kernel_matvec_cached.cu).
//
// Replaces the Pallas TPU kernel rbf_build_sym_tiles / _make_sym_build_kernel
// of linear_operator_tpu/ops/rbf.py.
//
// Output: tiles (npairs, tile, tile) bf16, pair s = (imap[s], jmap[s]) with
// j >= i in row-major triangle order; entry (r, c) of pair s is
// k(x[i tile + r], x[j tile + c]), x zero-padded past n.
//
// What bounds it on an H100: bytes.  At n = 1e5, tile 1024 it writes 4851
// tiles of 2 MiB, 1.02e10 bytes (3.04 ms at 3.35 TB/s), and evaluates 5.1e9
// entries at ~12 f32 flops each (~0.9 ms at 67 TFLOP/s); the inputs are 1.2 MB.
//
// Design.  One CTA of 256 threads per 128 x 128 sub-block of one tile pair
// (grid: npairs * (tile / 128)^2, 64-bit offsets into the output, which holds
// more than 2^32 elements at n = 1e5).  The 128 + 128 points of the sub-block
// are staged in shared memory; thread (rg, cg) of a 16 x 16 layout owns 8
// consecutive columns (their points in registers) and rows rg + 16 k, k < 8,
// and writes each row's 8 entries as one 16-byte store: a warp writes two
// 256-byte row segments.  Rounding to bf16 is round-to-nearest-even
// (__float2bfloat16_rn), as torch's .to(torch.bfloat16).
//
// Distances: d <= 8 sums the squared differences over d zero-padded to DS = 4
// or 8 in the order and with the separate roundings of the plain version
// (ops/rbf.py sq_dist: d2 = e0 e0, then d2 + ek ek; no FMA contraction), so
// the f32 distances agree bit for bit; d > 8 (DS = 0) takes the quadratic form
// (sq_i + sq_j) - 2 x_i.x_j, clamped at 0, whose summation order differs from
// the plain version's matrix product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "covar.cuh"

namespace {

constexpr int SB = 128;       // sub-block edge
constexpr int THREADS = 256;  // 16 x 16 thread layout
constexpr int CPT = 8;        // columns per thread: one 16-byte store of bf16
constexpr int RPT = 8;        // rows per thread

template <int COVAR, int DS>
__global__ void __launch_bounds__(THREADS)
build_sym_tiles_kernel(const float* __restrict__ x, const int* __restrict__ imap,
                       const int* __restrict__ jmap, __nv_bfloat16* __restrict__ tiles,
                       int n, int d, int tile, float alpha) {
  extern __shared__ float smem[];
  const int dx = DS > 0 ? DS : d;
  float* xi = smem;          // SB * dx, row points, [r][k]
  float* xj = xi + SB * dx;  // SB * dx, column points, [c][k]
  float* sqi = xj + SB * dx; // DS == 0: squared norms
  float* sqj = sqi + SB;

  const int subs = tile / SB;
  const long long blk = blockIdx.x;
  const long long pair = blk / (subs * subs);
  const int sub = static_cast<int>(blk % (subs * subs));
  const int sr = sub / subs, sc = sub % subs;
  const int i0 = imap[pair] * tile + sr * SB;  // first point of the rows
  const int j0 = jmap[pair] * tile + sc * SB;  // first point of the columns
  const int tid = threadIdx.x;

  for (int idx = tid; idx < SB * dx; idx += THREADS) {
    const int r = idx / dx, k = idx % dx;
    xi[idx] = (i0 + r < n && k < d) ? x[static_cast<size_t>(i0 + r) * d + k] : 0.0f;
    xj[idx] = (j0 + r < n && k < d) ? x[static_cast<size_t>(j0 + r) * d + k] : 0.0f;
  }
  __syncthreads();
  if (DS == 0) {
    if (tid < SB) {
      float a = 0.0f;
      for (int k = 0; k < d; ++k) a = fmaf(xi[tid * d + k], xi[tid * d + k], a);
      sqi[tid] = a;
    } else {
      const int c = tid - SB;
      float a = 0.0f;
      for (int k = 0; k < d; ++k) a = fmaf(xj[c * d + k], xj[c * d + k], a);
      sqj[c] = a;
    }
    __syncthreads();
  }

  const int cg = tid % 16, rg = tid / 16;
  const int c0 = cg * CPT;
  float xc[DS > 0 ? CPT * DS : 1];
  if constexpr (DS > 0) {
#pragma unroll
    for (int q = 0; q < CPT; ++q)
#pragma unroll
      for (int k = 0; k < DS; ++k) xc[q * DS + k] = xj[(c0 + q) * DS + k];
  }

  __nv_bfloat16* base = tiles + static_cast<size_t>(pair) * tile * tile +
                        static_cast<size_t>(sr * SB) * tile + sc * SB + c0;
#pragma unroll 1
  for (int k8 = 0; k8 < RPT; ++k8) {
    const int r = rg + 16 * k8;
    float e[CPT];
    if constexpr (DS > 0) {
      float xr[DS];
#pragma unroll
      for (int k = 0; k < DS; ++k) xr[k] = xi[r * DS + k];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        float diff = __fsub_rn(xr[0], xc[q * DS]);
        float d2 = __fmul_rn(diff, diff);
#pragma unroll
        for (int k = 1; k < DS; ++k) {
          diff = __fsub_rn(xr[k], xc[q * DS + k]);
          d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
        }
        e[q] = covar_fn<COVAR>(d2, alpha);
      }
    } else {
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        float inner = 0.0f;
        for (int k = 0; k < d; ++k) inner = fmaf(xi[r * d + k], xj[(c0 + q) * d + k], inner);
        const float d2 = fmaxf(__fsub_rn(__fadd_rn(sqi[r], sqj[c0 + q]), __fmul_rn(2.0f, inner)), 0.0f);
        e[q] = covar_fn<COVAR>(d2, alpha);
      }
    }
    uint4 packed;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int q = 0; q < CPT / 2; ++q) {
      h[q].x = __float2bfloat16_rn(e[2 * q]);
      h[q].y = __float2bfloat16_rn(e[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(base + static_cast<size_t>(r) * tile) = packed;
  }
}

template <int COVAR, int DS>
cudaError_t launch(const float* x, const int* imap, const int* jmap, __nv_bfloat16* tiles, int n,
                   int d, int tile, int npairs, float alpha, cudaStream_t stream) {
  const int dx = DS > 0 ? DS : d;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(SB) * dx + (DS == 0 ? 2 * SB : 0));
  auto kern = build_sym_tiles_kernel<COVAR, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long subs = tile / SB;
  const unsigned grid = static_cast<unsigned>(static_cast<long long>(npairs) * subs * subs);
  kern<<<grid, THREADS, smem, stream>>>(x, imap, jmap, tiles, n, d, tile, alpha);
  return cudaGetLastError();
}

template <int COVAR>
cudaError_t by_dims(const float* x, const int* imap, const int* jmap, __nv_bfloat16* tiles, int n,
                    int d, int tile, int npairs, float alpha, cudaStream_t stream) {
  if (d <= 4) return launch<COVAR, 4>(x, imap, jmap, tiles, n, d, tile, npairs, alpha, stream);
  if (d <= 8) return launch<COVAR, 8>(x, imap, jmap, tiles, n, d, tile, npairs, alpha, stream);
  return launch<COVAR, 0>(x, imap, jmap, tiles, n, d, tile, npairs, alpha, stream);
}

}  // namespace

// x (n, d) f32; imap, jmap (npairs,) int32 tile rows and columns of each pair;
// tiles (npairs, tile, tile) bf16; all contiguous on the device of `stream`.
// tile a positive multiple of 128, 1 <= d <= 128, npairs (tile / 128)^2 < 2^31.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int kernel_build_sym_tiles(const float* x, const int* imap, const int* jmap, void* tiles,
                                      int n, int d, int tile, int npairs, int covar, float alpha,
                                      void* stream) {
  const long long subs = tile / SB;
  if (n < 1 || d < 1 || d > 128 || tile < SB || tile % SB != 0 || npairs < 1 ||
      static_cast<long long>(npairs) * subs * subs >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (covar) {
    case COVAR_RBF: return by_dims<COVAR_RBF>(x, imap, jmap, out, n, d, tile, npairs, alpha, s);
    case COVAR_MATERN52: return by_dims<COVAR_MATERN52>(x, imap, jmap, out, n, d, tile, npairs, alpha, s);
    case COVAR_MATERN32: return by_dims<COVAR_MATERN32>(x, imap, jmap, out, n, d, tile, npairs, alpha, s);
    case COVAR_MATERN12: return by_dims<COVAR_MATERN12>(x, imap, jmap, out, n, d, tile, npairs, alpha, s);
    case COVAR_RQ: return by_dims<COVAR_RQ>(x, imap, jmap, out, n, d, tile, npairs, alpha, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
