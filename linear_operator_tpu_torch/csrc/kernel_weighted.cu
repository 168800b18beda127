// K2: the weighted-tile backward kernel.  With W_ij = k'(|x1_i - x2_j|^2)
// (g_i . v_j) it computes wx = W x2 (n, d) and ws = rowsum(W) (n), never
// storing W.  The callers (ops/rbf.py) assemble dx1 = 2 (ws x1 - wx), the
// x1-gradient of sum(g * (k(x1, x2) v)): the backward of K1 and K3.
//
// Replaces the Pallas TPU kernel _pallas_weighted / _make_weighted_kernel of
// linear_operator_tpu/ops/rbf.py.  The TPU kernel broadcasts rowsum(W) over
// 128 lanes, a layout artifact; here it is an (n,) vector.
//
// What bounds it on an H100: operations.  It moves (n + m)(d + t) + n (d + 1)
// floats but evaluates n m pairs, each costing the distance (3d flops), k'
// (an exp and a multiply), the dot g_i . v_j (2t), w (1), w x2_j (2d) and ws
// (1).  At the GP training step's n = m = 1e5, d = 3, t = 11 that is ~4.1e11
// f32 flops, ~6.1 ms at 67 TFLOP/s outside the tensor cores.
//
// Design: K1's (kernel_matvec.cu).  A CTA of NT = 128 threads owns BI rows of
// x1 (two per thread for d <= 8, one above), one chunk of TP <= 32 columns of
// g and v (the wrapper picks TP, a multiple of 4) and one split of MS = 4096
// points of x2 (grid.y = split x column chunk).  Each thread keeps its rows'
// x1 and g in registers; the CTA walks its split in steps of BJ = 128 points
// staged in shared memory with their v rows.  Per pair: d2, k'(d2), the dot
// s = g_i . v_j by f32 FMAs against the staged v row (read by broadcast),
// w = k' s, then wx += w x2_j and ws += w.  Each (split, chunk) writes its own
// partial and the wrapper sums them: no atomics, so the result is
// deterministic.  The split keeps every accumulation chain at 4096 terms,
// because dx = 2 (ws x1 - wx) is a difference of two large, nearly equal sums
// that one f32 chain over m = 1e5 terms would blur; it also fills the card at
// small n.  Column chunks are exact: W is linear in g and v, so their partials
// add.  The contraction is f32 FMAs on the CUDA cores, never TF32.
//
// Distances: as K1 -- differences over d zero-padded to DS = 4 or 8 for
// d <= 8 (wx accumulated in registers), the clamped quadratic form in one
// fixed FMA order for d > 8 (x1 rows and wx accumulators in shared memory,
// one row per thread, laid out [k][row] so a warp touches consecutive words).
#include <cuda_runtime.h>
#include <stdint.h>

#include "covar.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA
constexpr int BJ = 128;   // x2 points per shared-memory step (== NT)
constexpr int MS = 4096;  // x2 points per split (a multiple of BJ)

template <int COVAR, int TP, int DS>
__global__ void __launch_bounds__(NT)
weighted_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                const float* __restrict__ g, const float* __restrict__ v,
                float* __restrict__ wx_part, float* __restrict__ ws_part, int batch, int n,
                int m, int d, int t, int chunks, float alpha) {
  constexpr int RPT = DS > 0 ? 2 : 1;  // x1 rows per thread
  constexpr int BI = NT * RPT;         // x1 rows per CTA
  constexpr int DR = DS > 0 ? DS : 1;  // register row width
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);  // BJ * TP
  const int dx = DS > 0 ? DS : d;
  float* xs = vs + BJ * TP;   // BJ * dx, row-major [s][k]
  float* sqs = xs + BJ * dx;  // DS == 0: BJ squared norms
  float* x1t = sqs + BJ;      // DS == 0: d * BI, [k][row]
  float* wxt = x1t + d * BI;  // DS == 0: d * BI accumulators, [k][row]

  const size_t b = blockIdx.z;
  const int split = blockIdx.y / chunks;
  const int chunk = blockIdx.y % chunks;
  const size_t part = static_cast<size_t>(split) * chunks + chunk;
  x1 += b * n * d;
  x2 += b * m * d;
  g += b * n * t;
  v += b * m * t;
  float* wxo = wx_part + (part * batch + b) * n * d;
  float* wso = ws_part + (part * batch + b) * n;
  const int i0 = blockIdx.x * BI;
  const int c0 = chunk * TP;
  const int jend = min(m, (split + 1) * MS);
  const int tid = threadIdx.x;

  float gr[RPT][TP];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + tid + q * NT;
#pragma unroll
    for (int c = 0; c < TP; ++c)
      gr[q][c] = (gi < n && c0 + c < t) ? g[static_cast<size_t>(gi) * t + c0 + c] : 0.0f;
  }

  float xr[RPT][DR];
  float wacc[RPT][DR];
  float sqr[RPT];
  float sacc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    sacc[q] = 0.0f;
    sqr[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < DR; ++k) {
      xr[q][k] = 0.0f;
      wacc[q][k] = 0.0f;
    }
  }
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
      wxt[k * BI + row] = 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      float a = 0.0f;
      for (int k = 0; k < d; ++k) a = fmaf(x1t[k * BI + tid + q * NT], x1t[k * BI + tid + q * NT], a);
      sqr[q] = a;
    }
  }

  for (int j0 = split * MS; j0 < jend; j0 += BJ) {
    __syncthreads();  // the previous step's reads of vs / xs / sqs are done
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
      const float4* v4 = reinterpret_cast<const float4*>(vs + s * TP);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float d2;
        if constexpr (DS > 0) {
          d2 = sq_dist_diff<DS>(xr[q], xs + s * DS);
        } else {
          float inner = 0.0f;
          for (int k = 0; k < d; ++k) inner = fmaf(x1t[k * BI + tid + q * NT], xs[s * d + k], inner);
          d2 = fmaxf(sqr[q] + sqs[s] - 2.0f * inner, 0.0f);
        }
        float dot = 0.0f;
#pragma unroll
        for (int p = 0; p < TP / 4; ++p) {
          const float4 w4 = v4[p];
          dot = fmaf(gr[q][4 * p + 0], w4.x, dot);
          dot = fmaf(gr[q][4 * p + 1], w4.y, dot);
          dot = fmaf(gr[q][4 * p + 2], w4.z, dot);
          dot = fmaf(gr[q][4 * p + 3], w4.w, dot);
        }
        const float w = dcovar_fn<COVAR>(d2, alpha) * dot;
        sacc[q] += w;
        if constexpr (DS > 0) {
          const float4* x4 = reinterpret_cast<const float4*>(xs + s * DS);
#pragma unroll
          for (int p = 0; p < DS / 4; ++p) {
            const float4 xx = x4[p];
            wacc[q][4 * p + 0] = fmaf(w, xx.x, wacc[q][4 * p + 0]);
            wacc[q][4 * p + 1] = fmaf(w, xx.y, wacc[q][4 * p + 1]);
            wacc[q][4 * p + 2] = fmaf(w, xx.z, wacc[q][4 * p + 2]);
            wacc[q][4 * p + 3] = fmaf(w, xx.w, wacc[q][4 * p + 3]);
          }
        } else {
          for (int k = 0; k < d; ++k)
            wxt[k * BI + tid + q * NT] = fmaf(w, xs[s * d + k], wxt[k * BI + tid + q * NT]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int gi = i0 + tid + q * NT;
    if (gi >= n) continue;
    wso[gi] = sacc[q];
    if constexpr (DS > 0) {
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        if (k < d) wxo[static_cast<size_t>(gi) * d + k] = wacc[q][k];
      }
    } else {
      for (int k = 0; k < d; ++k) wxo[static_cast<size_t>(gi) * d + k] = wxt[k * BI + tid + q * NT];
    }
  }
}

template <int COVAR, int TP, int DS>
cudaError_t launch(const float* x1, const float* x2, const float* g, const float* v, float* wx,
                   float* ws, int batch, int n, int m, int d, int t, float alpha,
                   cudaStream_t stream) {
  constexpr int BI = NT * (DS > 0 ? 2 : 1);
  const size_t smem = sizeof(float) * (static_cast<size_t>(BJ) * TP + BJ * (DS > 0 ? DS : d) + BJ +
                                       (DS == 0 ? 2 * static_cast<size_t>(d) * BI : 0));
  auto kern = weighted_kernel<COVAR, TP, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int chunks = (t + TP - 1) / TP;
  const int splits = (m + MS - 1) / MS;
  const dim3 grid((n + BI - 1) / BI, chunks * splits, batch);
  kern<<<grid, NT, smem, stream>>>(x1, x2, g, v, wx, ws, batch, n, m, d, t, chunks, alpha);
  return cudaGetLastError();
}

template <int COVAR, int TP>
cudaError_t by_dims(const float* x1, const float* x2, const float* g, const float* v, float* wx,
                    float* ws, int batch, int n, int m, int d, int t, float alpha,
                    cudaStream_t stream) {
  if (d <= 4) return launch<COVAR, TP, 4>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
  if (d <= 8) return launch<COVAR, TP, 8>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
  return launch<COVAR, TP, 0>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
}

template <int COVAR>
cudaError_t by_chunk(int tp, const float* x1, const float* x2, const float* g, const float* v,
                     float* wx, float* ws, int batch, int n, int m, int d, int t, float alpha,
                     cudaStream_t stream) {
  switch (tp) {
    case 4: return by_dims<COVAR, 4>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
    case 8: return by_dims<COVAR, 8>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
    case 12: return by_dims<COVAR, 12>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
    case 16: return by_dims<COVAR, 16>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
    case 24: return by_dims<COVAR, 24>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
    case 32: return by_dims<COVAR, 32>(x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x1 (batch, n, d), x2 (batch, m, d), g (batch, n, t), v (batch, m, t); wx
// (parts, batch, n, d) and ws (parts, batch, n) with parts = ceil(m / 4096) *
// ceil(t / tp), one partial per (split, column chunk), the caller summing
// over parts; all f32, contiguous, on the device of `stream`.  tp, the
// columns per CTA, is 4, 8, 12, 16, 24 or 32; d <= 128.  Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int kernel_weighted_f32(const float* x1, const float* x2, const float* g,
                                   const float* v, float* wx, float* ws, int batch, int n, int m,
                                   int d, int t, int tp, int covar, float alpha, void* stream) {
  if (n < 1 || m < 1 || t < 1 || d < 1 || d > 128 || batch < 1 || batch > 65535 || tp < 1 ||
      static_cast<long long>((t + tp - 1) / tp) * ((m + MS - 1) / MS) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (covar) {
    case COVAR_RBF: return by_chunk<COVAR_RBF>(tp, x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, s);
    case COVAR_MATERN52:
      return by_chunk<COVAR_MATERN52>(tp, x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, s);
    case COVAR_MATERN32:
      return by_chunk<COVAR_MATERN32>(tp, x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, s);
    case COVAR_MATERN12:
      return by_chunk<COVAR_MATERN12>(tp, x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, s);
    case COVAR_RQ: return by_chunk<COVAR_RQ>(tp, x1, x2, g, v, wx, ws, batch, n, m, d, t, alpha, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
