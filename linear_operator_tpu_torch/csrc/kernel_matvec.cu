// K1: y = K v with K_ij = k(|x1_i - x2_j|^2), the rectangular stationary
// kernel mat-vec.  K is never stored: each entry is formed where it is used.
//
// Replaces the Pallas TPU kernel _pallas_matvec / _make_matvec_kernel of
// linear_operator_tpu/ops/rbf.py (wrapper kernel_matvec).
//
// What bounds it on an H100: operations.  It moves (n + m) d + m t + n t
// floats but evaluates n m entries, each costing the distance (~2d flops),
// one exp (MUFU) and t FMAs.  At the GP posterior's n = m = 1e5, t = 65 that
// is ~1.4e12 f32 flops, ~21 ms at 67 TFLOP/s outside the tensor cores.
//
// Design.  A CTA of NT = 128 threads owns BI = 256 rows of x1 (two per
// thread, x1 rows in registers), one chunk of TP <= 32 rhs columns (the
// wrapper picks TP so that few padded columns are computed) and one split of
// MS = 4096 points of x2 (grid.y = column chunk x split).  It walks its split
// in steps of BJ = 128 points staged in shared memory with their v rows; for
// each staged point every thread forms its two kernel entries and does 2 TP
// FMAs against the point's v row, read by broadcast.  Rows are accumulated in
// registers and written once per split to partial[split]; the wrapper sums
// the splits.  Splitting keeps each f32 accumulation chain at 4096 terms (one
// chain over m = 1e5 terms drifts ~2e-5 relative, which the posterior
// variance, a difference of nearly equal terms, magnifies), fills the card
// at small n, and keeps the result deterministic.  A wide rhs re-forms the
// kernel entries once per column chunk: the price of keeping the
// accumulators in registers.  The contraction is f32 FMAs on the CUDA cores
// (f32-faithful, as CG needs).
//
// Distances: as K3 -- differences over d zero-padded to DS = 4 or 8 for
// d <= 8, the clamped quadratic form in one fixed FMA order for d > 8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "covar.cuh"

namespace {

constexpr int NT = 128;       // threads per CTA
constexpr int RPT = 2;        // x1 rows per thread
constexpr int BI = NT * RPT;  // x1 rows per CTA
constexpr int BJ = 128;       // x2 points per shared-memory step (== NT)
constexpr int MS = 4096;      // x2 points per split (a multiple of BJ)

template <int COVAR, int TP, int DS>
__global__ void __launch_bounds__(NT)
matvec_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
              const float* __restrict__ v, float* __restrict__ partial, int batch, int n,
              int m, int d, int t, int chunks, float alpha) {
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // BJ * TP
  const int dx = DS > 0 ? DS : d;
  float* xs = vs + BJ * TP;                      // BJ * dx, row-major [s][k]
  float* sqs = xs + BJ * dx;                     // DS == 0: BJ squared norms
  float* x1t = sqs + BJ;                         // DS == 0: d * BI, [k][row]

  const size_t b = blockIdx.z;
  const int split = blockIdx.y / chunks;
  x1 += b * n * d;
  x2 += b * m * d;
  v += b * m * t;
  float* out = partial + (static_cast<size_t>(split) * batch + b) * n * t;
  const int i0 = blockIdx.x * BI;
  const int c0 = (blockIdx.y % chunks) * TP;
  const int jend = min(m, (split + 1) * MS);
  const int tid = threadIdx.x;

  float xr[RPT][DS > 0 ? DS : 1];
  float sqr[RPT];
  if constexpr (DS > 0) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int gi = i0 + tid + q * NT;
#pragma unroll
      for (int k = 0; k < DS; ++k)
        xr[q][k] = (gi < n && k < d) ? x1[static_cast<size_t>(gi) * d + k] : 0.0f;
    }
  } else {
    for (int idx = tid; idx < BI * d; idx += NT) {
      const int row = idx / d, k = idx % d;
      x1t[k * BI + row] = i0 + row < n ? x1[static_cast<size_t>(i0 + row) * d + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      float a = 0.0f;
      for (int k = 0; k < d; ++k) a = fmaf(x1t[k * BI + tid + q * NT], x1t[k * BI + tid + q * NT], a);
      sqr[q] = a;
    }
  }

  float acc[RPT][TP];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int c = 0; c < TP; ++c) acc[q][c] = 0.0f;

  for (int j0 = split * MS; j0 < jend; j0 += BJ) {
    __syncthreads();  // the previous step's reads of vs / xs are done
    for (int idx = tid; idx < BJ * TP; idx += NT) {
      const int s = idx / TP, c = idx % TP;
      vs[idx] = (j0 + s < jend && c0 + c < t) ? v[static_cast<size_t>(j0 + s) * t + c0 + c] : 0.0f;
    }
    for (int idx = tid; idx < BJ * dx; idx += NT) {
      const int s = idx / dx, k = idx % dx;
      xs[idx] = (j0 + s < jend && k < d) ? x2[static_cast<size_t>(j0 + s) * d + k] : 0.0f;
    }
    __syncthreads();
    if constexpr (DS == 0) {
      float a = 0.0f;
      for (int k = 0; k < d; ++k) a = fmaf(xs[tid * d + k], xs[tid * d + k], a);
      sqs[tid] = a;
      __syncthreads();
    }
    const int send = min(BJ, jend - j0);
    for (int s = 0; s < send; ++s) {
      float kv[RPT];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if constexpr (DS > 0) {
          kv[q] = covar_fn<COVAR>(sq_dist_diff<DS>(xr[q], xs + s * DS), alpha);
        } else {
          float inner = 0.0f;
          for (int k = 0; k < d; ++k) inner = fmaf(x1t[k * BI + tid + q * NT], xs[s * d + k], inner);
          kv[q] = covar_fn<COVAR>(fmaxf(sqr[q] + sqs[s] - 2.0f * inner, 0.0f), alpha);
        }
      }
      const float4* v4 = reinterpret_cast<const float4*>(vs + s * TP);
#pragma unroll
      for (int p = 0; p < TP / 4; ++p) {
        const float4 w = v4[p];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          acc[q][4 * p + 0] = fmaf(kv[q], w.x, acc[q][4 * p + 0]);
          acc[q][4 * p + 1] = fmaf(kv[q], w.y, acc[q][4 * p + 1]);
          acc[q][4 * p + 2] = fmaf(kv[q], w.z, acc[q][4 * p + 2]);
          acc[q][4 * p + 3] = fmaf(kv[q], w.w, acc[q][4 * p + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + tid + q * NT;
    if (gi >= n) continue;
#pragma unroll
    for (int c = 0; c < TP; ++c) {
      if (c0 + c < t) out[static_cast<size_t>(gi) * t + c0 + c] = acc[q][c];
    }
  }
}

size_t smem_bytes(int tp, int dx, bool quadratic, int d) {
  return sizeof(float) * (static_cast<size_t>(BJ) * tp + BJ * dx + BJ +
                          (quadratic ? static_cast<size_t>(d) * BI : 0));
}

template <int COVAR, int TP, int DS>
cudaError_t launch(const float* x1, const float* x2, const float* v, float* partial, int batch,
                   int n, int m, int d, int t, float alpha, cudaStream_t stream) {
  const size_t smem = smem_bytes(TP, DS > 0 ? DS : d, DS == 0, d);
  auto kern = matvec_kernel<COVAR, TP, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int chunks = (t + TP - 1) / TP;
  const int splits = (m + MS - 1) / MS;
  const dim3 grid((n + BI - 1) / BI, chunks * splits, batch);
  kern<<<grid, NT, smem, stream>>>(x1, x2, v, partial, batch, n, m, d, t, chunks, alpha);
  return cudaGetLastError();
}

template <int COVAR, int TP>
cudaError_t by_dims(const float* x1, const float* x2, const float* v, float* out, int batch,
                    int n, int m, int d, int t, float alpha, cudaStream_t stream) {
  if (d <= 4) return launch<COVAR, TP, 4>(x1, x2, v, out, batch, n, m, d, t, alpha, stream);
  if (d <= 8) return launch<COVAR, TP, 8>(x1, x2, v, out, batch, n, m, d, t, alpha, stream);
  return launch<COVAR, TP, 0>(x1, x2, v, out, batch, n, m, d, t, alpha, stream);
}

template <int COVAR>
cudaError_t by_chunk(int tp, const float* x1, const float* x2, const float* v, float* out,
                     int batch, int n, int m, int d, int t, float alpha, cudaStream_t stream) {
  switch (tp) {
    case 8: return by_dims<COVAR, 8>(x1, x2, v, out, batch, n, m, d, t, alpha, stream);
    case 16: return by_dims<COVAR, 16>(x1, x2, v, out, batch, n, m, d, t, alpha, stream);
    case 24: return by_dims<COVAR, 24>(x1, x2, v, out, batch, n, m, d, t, alpha, stream);
    case 32: return by_dims<COVAR, 32>(x1, x2, v, out, batch, n, m, d, t, alpha, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x1 (batch, n, d), x2 (batch, m, d), v (batch, m, t), partial (splits,
// batch, n, t) with splits = ceil(m / 4096), the caller summing over splits;
// all f32, contiguous, on the device of `stream`.  tp, the columns per CTA,
// is 8, 16, 24 or 32; d <= 128.  Returns the CUDA error of the launch (0 when
// it was accepted).
extern "C" int kernel_matvec_f32(const float* x1, const float* x2, const float* v, float* out,
                                 int batch, int n, int m, int d, int t, int tp, int covar,
                                 float alpha, void* stream) {
  if (n < 1 || m < 1 || t < 1 || d < 1 || d > 128 || batch < 1 || batch > 65535 ||
      static_cast<long long>((t + tp - 1) / tp) * ((m + MS - 1) / MS) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (covar) {
    case COVAR_RBF: return by_chunk<COVAR_RBF>(tp, x1, x2, v, out, batch, n, m, d, t, alpha, s);
    case COVAR_MATERN52:
      return by_chunk<COVAR_MATERN52>(tp, x1, x2, v, out, batch, n, m, d, t, alpha, s);
    case COVAR_MATERN32:
      return by_chunk<COVAR_MATERN32>(tp, x1, x2, v, out, batch, n, m, d, t, alpha, s);
    case COVAR_MATERN12:
      return by_chunk<COVAR_MATERN12>(tp, x1, x2, v, out, batch, n, m, d, t, alpha, s);
    case COVAR_RQ: return by_chunk<COVAR_RQ>(tp, x1, x2, v, out, batch, n, m, d, t, alpha, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
