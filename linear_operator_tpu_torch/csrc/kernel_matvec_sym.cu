// K3: y = K v for the symmetric stationary kernel matrix K_ij = k(|x_i - x_j|^2).
//
// Replaces the Pallas TPU kernel _pallas_matvec_sym / _make_sym_matvec_kernel
// of linear_operator_tpu/ops/rbf.py (wrapper kernel_matvec_sym).
//
// What bounds it on an H100: operations, not bytes.  It reads x (n, d) and
// v (n, t) and writes y (n, t) -- a few MB -- but evaluates n^2 / 2 kernel
// entries, each costing the distance (~2d flops), one exp (MUFU) and 2t FMAs
// for the row and column contractions.  At n = 1e5, t = 11 that is ~2.7e11
// f32 flops, ~4 ms at the card's 67 TFLOP/s outside the tensor cores.
//
// Design.  One CTA of B = 128 threads per upper-triangle tile pair
// (bi <= bj) of B x B entries, so each off-diagonal entry is formed once:
//  1. x and v of both blocks are staged in shared memory, zero-padded past n
//     and past t (a padded point carries v = 0, so it adds nothing).
//  2. Thread s owns column s of the tile: it forms K[r][s] for every row r,
//     stores it to a shared K tile, and accumulates the column contribution
//     sum_r K[r][s] v_i[r] in registers (v_i read by broadcast).
//  3. After a barrier, thread r owns row r and accumulates the row
//     contribution sum_s K[r][s] v_j[s] from the shared tile.
//  4. Both partials go to the output with atomicAdd; the wrapper zeroes it.
//     A diagonal tile (bi == bj) adds its row contribution only.
// The output is carried transposed, (t, n), so the atomics of a warp land on
// consecutive addresses.  The contraction is f32 FMAs on the CUDA cores:
// f32-faithful, as CG needs (single-pass TF32 or bf16 would stall it).
//
// Reproducibility: the order in which CTAs add to an output element varies
// from run to run, so two runs on the same inputs may differ in the last
// bits of y (f32 rounding of a sum over ~n / B partials); they agree to
// ~1e-6 relative, and each run is a symmetric f32-accurate K v.
//
// Distances: d <= 8 sums squared differences over d zero-padded to DS = 4 or
// 8 (exact in f32); d > 8 (DS = 0) uses the quadratic form sq_i + sq_j -
// 2 x_i.x_j with f32 FMAs in one fixed order, clamped at 0, so a point's
// distance to itself is exactly 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "covar.cuh"

namespace {

constexpr int B = 128;       // tile edge, and threads per CTA
constexpr int KS = B + 1;    // row stride of the shared K tile (no bank conflicts)

__device__ __forceinline__ void decode_pair(long long s, int& bi, int& bj) {
  // s = bj (bj + 1) / 2 + bi with 0 <= bi <= bj
  int j = static_cast<int>((sqrt(8.0 * static_cast<double>(s) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(j + 1) * (j + 2) / 2 <= s) ++j;
  while (static_cast<long long>(j) * (j + 1) / 2 > s) --j;
  bj = j;
  bi = static_cast<int>(s - static_cast<long long>(j) * (j + 1) / 2);
}

template <int COVAR, int TP, int DS>
__global__ void __launch_bounds__(B)
sym_matvec_kernel(const float* __restrict__ x, const float* __restrict__ v,
                  float* __restrict__ out_t, int n, int d, int t, float alpha) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // B * KS
  float* vi = Ks + B * KS;                       // B * TP, rows of block bi
  float* vj = vi + B * TP;                       // B * TP, rows of block bj
  const int dx = DS > 0 ? DS : d;
  float* xi = vj + B * TP;                       // B * dx, row-major [r][k]
  float* xj = xi + B * dx;                       // DS > 0: [s][k]; DS == 0: [k][s]
  float* sqi = xj + B * dx;                      // DS == 0: squared norms
  float* sqj = sqi + B;

  int bi, bj;
  decode_pair(blockIdx.x, bi, bj);
  const size_t b = blockIdx.y;
  x += b * n * d;
  v += b * n * t;
  out_t += b * t * n;
  const int i0 = bi * B, j0 = bj * B;
  const int tid = threadIdx.x;
  const bool diag_tile = bi == bj;

  for (int idx = tid; idx < B * TP; idx += B) {
    const int r = idx / TP, c = idx % TP;
    vi[idx] = (i0 + r < n && c < t) ? v[static_cast<size_t>(i0 + r) * t + c] : 0.0f;
    vj[idx] = (j0 + r < n && c < t) ? v[static_cast<size_t>(j0 + r) * t + c] : 0.0f;
  }
  for (int idx = tid; idx < B * dx; idx += B) {
    const int r = idx / dx, k = idx % dx;
    const float a = (i0 + r < n && k < d) ? x[static_cast<size_t>(i0 + r) * d + k] : 0.0f;
    const float c = (j0 + r < n && k < d) ? x[static_cast<size_t>(j0 + r) * d + k] : 0.0f;
    xi[idx] = a;
    xj[DS > 0 ? idx : k * B + r] = c;
  }
  __syncthreads();
  if (DS == 0) {
    float a = 0.0f, c = 0.0f;
    for (int k = 0; k < d; ++k) {
      a = fmaf(xi[tid * d + k], xi[tid * d + k], a);
      c = fmaf(xj[k * B + tid], xj[k * B + tid], c);
    }
    sqi[tid] = a;
    sqj[tid] = c;
    __syncthreads();
  }

  // 2. column s = tid: form K[:, s], accumulate sum_r K[r][s] v_i[r]
  {
    const int s = tid;
    float xs[DS > 0 ? DS : 1];
    if constexpr (DS > 0) {
#pragma unroll
      for (int k = 0; k < DS; ++k) xs[k] = xj[s * DS + k];
    }
    auto entry = [&](int r) -> float {
      if constexpr (DS > 0) {
        return covar_fn<COVAR>(sq_dist_diff<DS>(xs, xi + r * DS), alpha);
      } else {
        float inner = 0.0f;
        for (int k = 0; k < d; ++k) inner = fmaf(xi[r * d + k], xj[k * B + s], inner);
        return covar_fn<COVAR>(fmaxf(sqi[r] + sqj[s] - 2.0f * inner, 0.0f), alpha);
      }
    };
    float acc[TP];
#pragma unroll
    for (int c = 0; c < TP; ++c) acc[c] = 0.0f;
    const int rend = min(B, n - i0);  // rows past n are never read back
    if (diag_tile) {
      for (int r = 0; r < rend; ++r) Ks[r * KS + s] = entry(r);
    } else {
      for (int r = 0; r < rend; ++r) {
        const float kv = entry(r);
        Ks[r * KS + s] = kv;
        axpy_row<TP>(acc, kv, vi + r * TP);
      }
    }
    if (!diag_tile && j0 + s < n) {
#pragma unroll
      for (int c = 0; c < TP; ++c) {
        if (c < t) atomicAdd(out_t + static_cast<size_t>(c) * n + j0 + s, acc[c]);
      }
    }
  }
  __syncthreads();

  // 3. row r = tid: accumulate sum_s K[r][s] v_j[s]
  {
    const int r = tid;
    float acc[TP];
#pragma unroll
    for (int c = 0; c < TP; ++c) acc[c] = 0.0f;
    const int send = min(B, n - j0);
    if (i0 + r < n) {
      for (int s = 0; s < send; ++s) axpy_row<TP>(acc, Ks[r * KS + s], vj + s * TP);
#pragma unroll
      for (int c = 0; c < TP; ++c) {
        if (c < t) atomicAdd(out_t + static_cast<size_t>(c) * n + i0 + r, acc[c]);
      }
    }
  }
}

size_t smem_bytes(int tp, int dx, bool quadratic) {
  return sizeof(float) *
         (static_cast<size_t>(B) * KS + 2 * B * tp + 2 * B * dx + (quadratic ? 2 * B : 0));
}

template <int COVAR, int TP, int DS>
cudaError_t launch(const float* x, const float* v, float* out_t, int batch, int n, int d,
                   int t, float alpha, cudaStream_t stream) {
  const size_t smem = smem_bytes(TP, DS > 0 ? DS : d, DS == 0);
  auto kern = sym_matvec_kernel<COVAR, TP, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long nblk = (n + B - 1) / B;
  const dim3 grid(static_cast<unsigned>(nblk * (nblk + 1) / 2), batch);
  kern<<<grid, B, smem, stream>>>(x, v, out_t, n, d, t, alpha);
  return cudaGetLastError();
}

template <int COVAR, int TP>
cudaError_t by_dims(const float* x, const float* v, float* out_t, int batch, int n, int d, int t,
                    float alpha, cudaStream_t stream) {
  if (d <= 4) return launch<COVAR, TP, 4>(x, v, out_t, batch, n, d, t, alpha, stream);
  if (d <= 8) return launch<COVAR, TP, 8>(x, v, out_t, batch, n, d, t, alpha, stream);
  return launch<COVAR, TP, 0>(x, v, out_t, batch, n, d, t, alpha, stream);
}

template <int COVAR>
cudaError_t by_columns(const float* x, const float* v, float* out_t, int batch, int n, int d,
                       int t, float alpha, cudaStream_t stream) {
  if (t <= 4) return by_dims<COVAR, 4>(x, v, out_t, batch, n, d, t, alpha, stream);
  if (t <= 8) return by_dims<COVAR, 8>(x, v, out_t, batch, n, d, t, alpha, stream);
  if (t <= 12) return by_dims<COVAR, 12>(x, v, out_t, batch, n, d, t, alpha, stream);
  return by_dims<COVAR, 16>(x, v, out_t, batch, n, d, t, alpha, stream);
}

}  // namespace

// x (batch, n, d), v (batch, n, t), out_t (batch, t, n) zeroed by the caller;
// all f32, contiguous, on the device of `stream`.  1 <= t <= 16, d <= 128.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int kernel_matvec_sym_f32(const float* x, const float* v, float* out_t, int batch,
                                     int n, int d, int t, int covar, float alpha, void* stream) {
  if (t < 1 || t > 16 || d < 1 || d > 128 || n < 1 || batch < 1 || batch > 65535 ||
      (n + B - 1) / B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (covar) {
    case COVAR_RBF: return by_columns<COVAR_RBF>(x, v, out_t, batch, n, d, t, alpha, s);
    case COVAR_MATERN52: return by_columns<COVAR_MATERN52>(x, v, out_t, batch, n, d, t, alpha, s);
    case COVAR_MATERN32: return by_columns<COVAR_MATERN32>(x, v, out_t, batch, n, d, t, alpha, s);
    case COVAR_MATERN12: return by_columns<COVAR_MATERN12>(x, v, out_t, batch, n, d, t, alpha, s);
    case COVAR_RQ: return by_columns<COVAR_RQ>(x, v, out_t, batch, n, d, t, alpha, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
