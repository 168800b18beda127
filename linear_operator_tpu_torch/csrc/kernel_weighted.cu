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
// floats but evaluates n m pairs.  Each costs the distance, k' (one exponent),
// w = k' s, w x2_j and the row sum on the CUDA cores, and the dot s = g_i . v_j,
// which runs as the TPU kernel's _dot_acc3: three bf16 passes on the tensor
// cores.  At the GP training step's n = m = 1e5, d = 3, t = 11: the formation
// and reductions ~2.8 ms at 67 TFLOP/s, the dot ~0.7 ms at the bf16 peak
// (~2 ms at the rate mma.sync reaches), the exponents ~2.4 ms on the
// special-function units.
//
// Design, as K1's (kernel_matvec.cu) with g v^T in place of K v:
//  - A CTA of 4 warps owns BI rows of x1 (16 MB a warp: MB m16 blocks) and
//    one split of MS = 4096 points of x2 (grid.y = split, times a chunk of 8
//    dimensions for d > 8).  The whole t runs as KS k-steps of 16 in one
//    pass, so every entry is formed once.
//  - g is split once per CTA into bf16 hi and lo A fragments, held in
//    registers.  A prepass pads x2 (acc3_mma.cuh) and splits v into bf16
//    B-fragment words (one 16-byte load a lane per n8 block and k-step), once
//    per launch; the CTA stages them with cp.async in steps of BJ = 64
//    points, double-buffered.
//  - Per n8 block of points the three products of _dot_acc3 give s in the
//    C-fragment layout: a thread holds rows g, g + 8 and points 2q, 2q + 1 of
//    each m16 block.  It forms d2 of those four pairs in registers (exact
//    differences for d <= 8, the clamped quadratic form in a fixed FMA order
//    above), k' with dcovar_fast (ex2.approx), w = k' s, and adds w x2_j and
//    w to its rows' sums: f32 FMAs.  The four lanes of a quad, which share
//    rows, are summed by shuffles at the end, and the constant factor of k'
//    applied once.
//  - s of each n8 block goes to a fresh accumulator: the tensor cores add
//    with truncation, and the chain is only 3 KS products long.
//  - Each split writes its own partial and the wrapper sums them: no atomics,
//    so the result is deterministic, and every accumulation chain stays at
//    1024 terms a lane, because dx = 2 (ws x1 - wx) is a difference of two
//    large, nearly equal sums that one f32 chain over m = 1e5 terms would
//    blur.
//  - d > 8: the sums of W x2 take 8 dimensions a CTA (registers), so the
//    entries are formed ceil(d / 8) times.  Off the GP main path (d = 3).
// Padded points and columns carry v = 0, padded rows g = 0: they add nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "acc3_mma.cuh"

namespace {

constexpr int NW = 4;         // warps per CTA
constexpr int NT = 32 * NW;   // threads per CTA
constexpr int BJ = 64;        // x2 points per staged step
constexpr int MS = 4096;      // x2 points per split (a multiple of BJ)
constexpr int DC = 8;         // dimensions of W x2 a CTA sums for d > 8

// rows of x2 in the prepass: 4 floats for d <= 3, 8 for d <= 8, else d
// rounded up to 4
inline int k2_dim(int d) { return d <= 3 ? 4 : d <= 8 ? 8 : (d + 3) / 4 * 4; }

// v (batch, m, t) as bf16 B-fragment words: for batch b, n8 block jb of
// points, k-step ks and lane (g, q), {hi, hi', lo, lo'} of v's columns
// (16 ks + 2q, +1) and (16 ks + 2q + 8, +9) at point 8 jb + g.  Zero past m
// and past t.
static __global__ void split_vt_kernel(const float* __restrict__ v, uint4* __restrict__ vw, int batch, int m,
                                       int t, int m8, int ks_n) {
  const long long total = static_cast<long long>(batch) * m8 * ks_n * 32;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int lane = static_cast<int>(idx % 32);
    long long r = idx / 32;
    const int ks = static_cast<int>(r % ks_n);
    r /= ks_n;
    const int jb = static_cast<int>(r % m8), b = static_cast<int>(r / m8);
    const int p = 8 * jb + lane / 4, c = 16 * ks + 2 * (lane % 4);
    const float* vp = v + (static_cast<size_t>(b) * m + p) * t;
    auto at = [&](int col) { return (p < m && col < t) ? vp[col] : 0.0f; };
    uint4 w;
    split_bf16x2(at(c), at(c + 1), w.x, w.z);
    split_bf16x2(at(c + 8), at(c + 9), w.y, w.w);
    vw[idx] = w;
  }
}

// DU: dimensions held in registers (3 for d <= 3, 8 for d <= 8; 0 takes the
// quadratic form, d > 8).  KS: k-steps of 16 columns of g and v.
template <int COVAR, int KS, int DU>
__global__ void __launch_bounds__(NT)
weighted_kernel(const float* __restrict__ x1, const float* __restrict__ g, const float* __restrict__ xp,
                const float* __restrict__ sqp, const uint4* __restrict__ vw, float* __restrict__ wx_part,
                float* __restrict__ ws_part, int batch, int n, int m, int mpad, int d, int dx, int t, int dchunks,
                float alpha) {
  constexpr int MB = KS <= 4 ? 2 : 1;        // m16 blocks a warp
  constexpr int BI = 16 * MB * NW;           // x1 rows a CTA
  constexpr int DP = DU == 3 ? 4 : 8;        // floats of a staged point (DU > 0)
  constexpr int XS = DU > 0 ? BJ * DP : 4;   // floats of a step's staged points (DU == 0 reads xp)
  constexpr int VS = BJ / 8 * KS * 32;       // uint4 of a step's staged v words
  constexpr int DW = DU > 0 ? DU : DC;       // dimensions of W x2 a thread sums
  extern __shared__ float4 smem4[];
  uint4* vsm = reinterpret_cast<uint4*>(smem4);              // 2 x VS
  float* xsm = reinterpret_cast<float*>(vsm + 2 * VS);       // 2 x XS

  const size_t b = blockIdx.z;
  const int split = blockIdx.y / dchunks, dc = blockIdx.y % dchunks;
  x1 += b * n * d;
  g += b * n * t;
  xp += b * mpad * dx;
  sqp += b * mpad;
  vw += b * (mpad / 8) * KS * 32;
  float* wxo = wx_part + (static_cast<size_t>(split) * batch + b) * n * d;
  float* wso = ws_part + (static_cast<size_t>(split) * batch + b) * n;
  const int i0 = blockIdx.x * BI;
  const int jbeg = split * MS;
  const int nsteps = (min(m, jbeg + MS) - jbeg + BJ - 1) / BJ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, q = lane & 3;

  // g of rows gr, gr + 8 of each m block as split A fragments: a0 (gr, 2q..),
  // a1 (gr + 8, 2q..), a2 (gr, 2q + 8..), a3 (gr + 8, 2q + 8..)
  SplitA ga[MB][KS];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int r0 = i0 + 16 * (MB * warp + mb) + gr;
    auto at = [&](int row, int col) { return (row < n && col < t) ? g[static_cast<size_t>(row) * t + col] : 0.0f; };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c0 = 16 * ks + 2 * q;
      split_bf16x2(at(r0, c0), at(r0, c0 + 1), ga[mb][ks].hi[0], ga[mb][ks].lo[0]);
      split_bf16x2(at(r0 + 8, c0), at(r0 + 8, c0 + 1), ga[mb][ks].hi[1], ga[mb][ks].lo[1]);
      split_bf16x2(at(r0, c0 + 8), at(r0, c0 + 9), ga[mb][ks].hi[2], ga[mb][ks].lo[2]);
      split_bf16x2(at(r0 + 8, c0 + 8), at(r0 + 8, c0 + 9), ga[mb][ks].hi[3], ga[mb][ks].lo[3]);
    }
  }

  // x1 rows gr and gr + 8 of each m block: DU > 0 in registers, DU == 0 as
  // pointers into x1 with their squared norms
  float xr[MB][2][DU > 0 ? DU : 1];
  const float* rp[MB][2];
  float sr[MB][2];
  float wacc[MB][2][DW];
  float sacc[MB][2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + 16 * (MB * warp + mb) + gr + 8 * r;
      if constexpr (DU > 0) {
#pragma unroll
        for (int k = 0; k < DU; ++k) xr[mb][r][k] = (row < n && k < d) ? x1[static_cast<size_t>(row) * d + k] : 0.0f;
      } else {
        rp[mb][r] = x1 + static_cast<size_t>(min(row, n - 1)) * d;  // rows past n are never written
        sr[mb][r] = sq_norm(rp[mb][r], d);
      }
      sacc[mb][r] = 0.0f;
#pragma unroll
      for (int k = 0; k < DW; ++k) wacc[mb][r][k] = 0.0f;
    }

  // copies of the step at x2 point j0 into buffer buf
  auto stage = [&](int buf, int j0) {
    uint4* dst = vsm + buf * VS;
    const uint4* src = vw + static_cast<size_t>(j0 / 8) * KS * 32;
    for (int idx = tid; idx < VS; idx += NT) cp_async16(dst + idx, src + idx);
    if constexpr (DU > 0) {
      for (int idx = tid; idx < XS / 4; idx += NT)
        cp_async16(xsm + buf * XS + 4 * idx, xp + static_cast<size_t>(j0) * DP + 4 * idx);
    }
  };

  stage(0, jbeg);
  cp_async_commit();
  for (int st = 0; st < nsteps; ++st) {
    const int j0 = jbeg + st * BJ, buf = st & 1;
    if (st + 1 < nsteps) stage(buf ^ 1, j0 + BJ);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // this step's copies, every thread's, have landed
    const uint4* vb = vsm + buf * VS;
    const float* xb = xsm + buf * XS;

#pragma unroll 1
    for (int nb = 0; nb < BJ / 8; ++nb) {
      // s = g . v for rows gr (+8) and points 2q (+1) of the block
      float s[MB][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mb][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint4 w = vb[(nb * KS + ks) * 32 + lane];
        const SplitB vf = {{w.x, w.y}, {w.z, w.w}};
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) acc3(s[mb], ga[mb][ks], vf);
      }

      float xc[2][DU > 0 ? DU : 1];
      const float* cp[2];
      float sc[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int p = 8 * nb + 2 * q + c;
        if constexpr (DU > 0) {
          const float4* x4 = reinterpret_cast<const float4*>(xb + p * DP);
#pragma unroll
          for (int k4 = 0; k4 < DP / 4; ++k4) {
            const float4 u = x4[k4];
            const float uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * k4 + e < DU) xc[c][4 * k4 + e] = uu[e];
          }
        } else {
          cp[c] = xp + static_cast<size_t>(j0 + p) * dx;
          sc[c] = sqp[j0 + p];
        }
      }

#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        float d2[2][2];
        if constexpr (DU > 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) d2[r][c] = diff_d2<DU>(xr[mb][r], xc[c]);
        } else {
          float inner[2][2] = {};
          for (int k = 0; k < d; ++k) {
            const float a0 = rp[mb][0][k], a1 = rp[mb][1][k];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float bk = cp[c][k];
              inner[0][c] = fmaf(a0, bk, inner[0][c]);
              inner[1][c] = fmaf(a1, bk, inner[1][c]);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) d2[r][c] = fmaxf(sr[mb][r] + sc[c] - 2.0f * inner[r][c], 0.0f);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float w = dcovar_fast<COVAR>(d2[r][c], alpha) * s[mb][2 * r + c];
            sacc[mb][r] += w;
#pragma unroll
            for (int k = 0; k < DW; ++k) {
              if constexpr (DU > 0) {
                wacc[mb][r][k] = fmaf(w, xc[c][k], wacc[mb][r][k]);
              } else {
                const int kk = DC * dc + k;
                wacc[mb][r][k] = fmaf(w, kk < d ? cp[c][kk] : 0.0f, wacc[mb][r][k]);
              }
            }
          }
      }
    }
    __syncthreads();  // every read of buffer buf is done before it is refilled
  }

  // the quad's four lanes hold the same rows: sum them, scale, write
  const float scale = dcovar_scale<COVAR>();
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sv = sacc[mb][r];
      sv += __shfl_xor_sync(0xffffffffu, sv, 1);
      sv += __shfl_xor_sync(0xffffffffu, sv, 2);
      float wv[DW];
#pragma unroll
      for (int k = 0; k < DW; ++k) {
        wv[k] = wacc[mb][r][k];
        wv[k] += __shfl_xor_sync(0xffffffffu, wv[k], 1);
        wv[k] += __shfl_xor_sync(0xffffffffu, wv[k], 2);
      }
      const int row = i0 + 16 * (MB * warp + mb) + gr + 8 * r;
      if (q != 0 || row >= n) continue;
      if (dc == 0) wso[row] = scale * sv;
#pragma unroll
      for (int k = 0; k < DW; ++k) {
        const int kk = DU > 0 ? k : DC * dc + k;
        if (kk < d) wxo[static_cast<size_t>(row) * d + kk] = scale * wv[k];
      }
    }
}

// k-steps of 16 columns the kernel is built for; t runs padded to the next
int k_steps(int t) { return t <= 16 ? 1 : t <= 32 ? 2 : t <= 64 ? 4 : t <= 80 ? 5 : t <= 128 ? 8 : -1; }

int dims_in_registers(int d) { return d <= 3 ? 3 : d <= 8 ? 8 : 0; }

// the prepass's layout in the scratch
struct Layout {
  size_t xp, sq, vw;  // byte offsets
  size_t bytes;
};

Layout layout(int batch, int m, int d, int t) {
  const size_t mpad = padded_points(m);
  Layout l;
  l.xp = 0;
  l.sq = l.xp + sizeof(float) * batch * mpad * k2_dim(d);
  l.vw = (l.sq + sizeof(float) * batch * mpad + 15) / 16 * 16;
  l.bytes = l.vw + sizeof(uint4) * batch * (mpad / 8) * k_steps(t) * 32;
  return l;
}

template <int COVAR, int KS, int DU>
cudaError_t launch(const float* x1, const float* g, const float* xp, const float* sq, const uint4* vw, float* wx,
                   float* ws, int batch, int n, int m, int mpad, int d, int dx, int t, float alpha,
                   cudaStream_t stream) {
  constexpr int MB = KS <= 4 ? 2 : 1;
  constexpr int BI = 16 * MB * NW;
  const size_t smem = sizeof(uint4) * 2 * (BJ / 8) * KS * 32 + sizeof(float) * 2 * (DU > 0 ? BJ * (DU == 3 ? 4 : 8) : 4);
  auto kern = weighted_kernel<COVAR, KS, DU>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int dchunks = DU > 0 ? 1 : (d + DC - 1) / DC;
  const int splits = (m + MS - 1) / MS;
  const dim3 grid((n + BI - 1) / BI, splits * dchunks, batch);
  kern<<<grid, NT, smem, stream>>>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, dchunks, alpha);
  return cudaGetLastError();
}

template <int COVAR, int KS>
cudaError_t by_dims(const float* x1, const float* g, const float* xp, const float* sq, const uint4* vw, float* wx,
                    float* ws, int batch, int n, int m, int mpad, int d, int dx, int t, float alpha,
                    cudaStream_t stream) {
  switch (dims_in_registers(d)) {
    case 3: return launch<COVAR, KS, 3>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
    case 8: return launch<COVAR, KS, 8>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
    default: return launch<COVAR, KS, 0>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
  }
}

template <int COVAR>
cudaError_t by_steps(const float* x1, const float* g, const float* xp, const float* sq, const uint4* vw, float* wx,
                     float* ws, int batch, int n, int m, int mpad, int d, int dx, int t, float alpha,
                     cudaStream_t stream) {
  switch (k_steps(t)) {
    case 1: return by_dims<COVAR, 1>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
    case 2: return by_dims<COVAR, 2>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
    case 4: return by_dims<COVAR, 4>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
    case 5: return by_dims<COVAR, 5>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
    default: return by_dims<COVAR, 8>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, stream);
  }
}

bool valid(int batch, int m, int d, int t) {
  return batch >= 1 && batch <= 65535 && m >= 1 && d >= 1 && t >= 1 && k_steps(t) > 0;
}

}  // namespace

// Bytes of the scratch that kernel_weighted_f32 takes for these shapes.
extern "C" long long kernel_weighted_f32_scratch(int batch, int m, int d, int t) {
  if (!valid(batch, m, d, t)) return -1;
  return static_cast<long long>(layout(batch, m, d, t).bytes);
}

// x1 (batch, n, d), x2 (batch, m, d), g (batch, n, t), v (batch, m, t); wx
// (splits, batch, n, d) and ws (splits, batch, n) with splits = ceil(m /
// 4096), one partial per split, the caller summing them; scratch of
// kernel_weighted_f32_scratch bytes (16-byte aligned); all f32, contiguous,
// on the device of `stream`.  t <= 128 and batch <= 65535 (grid.z): ops/rbf.py
// launches a wider g and v in column chunks and a larger batch in groups.
// Returns the CUDA error of the launches (0 when they were accepted).
extern "C" int kernel_weighted_f32(const float* x1, const float* x2, const float* g, const float* v, float* wx,
                                   float* ws, void* scratch, int batch, int n, int m, int d, int t, int covar,
                                   float alpha, void* stream) {
  if (n < 1 || !valid(batch, m, d, t) || covar < 0 || covar >= NUM_COVARS ||
      static_cast<long long>((m + MS - 1) / MS) * (d > 8 ? (d + DC - 1) / DC : 1) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(batch, m, d, t);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* xp = reinterpret_cast<float*>(base + l.xp);
  float* sq = reinterpret_cast<float*>(base + l.sq);
  uint4* vw = reinterpret_cast<uint4*>(base + l.vw);
  const int mpad = padded_points(m), dx = k2_dim(d), ks = k_steps(t);
  const int threads = 256;
  auto blocks = [](long long work) { return static_cast<unsigned>(work / threads + 1 < 8192 ? work / threads + 1 : 8192); };
  pad_points_kernel<<<blocks(static_cast<long long>(batch) * mpad), threads, 0, s>>>(x2, xp, sq, batch, m, d, mpad, dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_vt_kernel<<<blocks(static_cast<long long>(batch) * (mpad / 8) * ks * 32), threads, 0, s>>>(
      v, vw, batch, m, t, mpad / 8, ks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  switch (covar) {
    case COVAR_RBF: return by_steps<COVAR_RBF>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, s);
    case COVAR_MATERN52:
      return by_steps<COVAR_MATERN52>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, s);
    case COVAR_MATERN32:
      return by_steps<COVAR_MATERN32>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, s);
    case COVAR_MATERN12:
      return by_steps<COVAR_MATERN12>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, s);
#ifdef LO_USER_COVAR
    case COVAR_USER: return by_steps<COVAR_USER>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, s);
#endif
    default: return by_steps<COVAR_RQ>(x1, g, xp, sq, vw, wx, ws, batch, n, m, mpad, d, dx, t, alpha, s);
  }
}
