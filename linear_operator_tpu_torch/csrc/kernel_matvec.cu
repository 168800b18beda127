// K1: y = K v with K_ij = k(|x1_i - x2_j|^2), the rectangular stationary
// kernel mat-vec.  K is never stored: each entry is formed where it is used.
//
// Replaces the Pallas TPU kernel _pallas_matvec / _make_matvec_kernel of
// linear_operator_tpu/ops/rbf.py (wrapper kernel_matvec).
//
// What bounds it on an H100: operations.  It moves (n + m) d + m t + n t
// floats but forms n m entries, each costing the distance and exponent
// (3d + 1 f32 operations and one special-function result) and 2t products in
// each of the three bf16 passes of the TPU kernel's _dot_acc3.  At the GP
// posterior's n = m = 1e5, d = 3, t = 65: the products take 3.9 ms on the
// bf16 tensor cores, the formation 1.5 ms at 67 TFLOP/s, the exponents
// ~2.6 ms at 16 per SM and clock.
//
// Design, shaped like FlashAttention's P V.  A CTA of 4 warps owns BI = 128
// rows of x1 (32 per warp: two m16 blocks), one chunk of up to 72 rhs columns
// (NB n8 blocks, so t = 65 runs in one chunk and each entry is formed once)
// and one split of MS = 4096 points of x2 (grid.y = column chunk x split).
// A prepass (acc3_mma.cuh) pads x2 and splits v into bf16 hi and lo
// B-fragment words once per launch.  The CTA walks its split in steps of
// BJ = 64 points, staged in shared memory with cp.async, double-buffered so
// that the next step's copies overlap this step's work; each warp forms its
// 32 x 16 block of entries per 16 points directly in registers, in the
// A-fragment layout of mma.sync m16n8k16, and issues the three products of
// _dot_acc3 (acc3_mma.cuh).  Each 16-point chunk's products go to a fresh
// accumulator that is then added to the row sums (f32, round to nearest):
// the tensor cores add into their accumulator with truncation, which over a
// 4096-point chain of large sums drifts ~1e-5 relative.  The row sums stay
// in registers for the split and are written once to partial[split]; the
// wrapper sums the splits.  Splitting keeps each f32 accumulation chain at 4096 terms (one
// chain over m = 1e5 terms drifts ~2e-5 relative, which the posterior
// variance, a difference of nearly equal terms, magnifies), fills the card
// at small n, and keeps the result deterministic.  Padded points and columns
// carry v = 0 and add nothing.
//
// Distances: as K3 -- differences over d zero-padded to DS = 4 or 8 for
// d <= 8, the clamped quadratic form in one fixed FMA order for d > 8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "acc3_mma.cuh"

namespace {

constexpr int NW = 4;                  // warps per CTA
constexpr int NT = 32 * NW;            // threads per CTA
constexpr int BI = 32 * NW;            // x1 rows per CTA: 32 per warp, two m16 blocks
constexpr int BJ = 64;                 // x2 points per staged step
constexpr int MS = 4096;               // x2 points per split (a multiple of BJ)
constexpr int VQ = 4 * (BJ / 16) + 4;  // uint4 per column of a staged step (+4: conflict-free loads)

template <int COVAR, int NB, int DS>
__global__ void __launch_bounds__(NT)
matvec_kernel(const float* __restrict__ x1, const float* __restrict__ xp, const float* __restrict__ sqp,
              const uint4* __restrict__ vs, float* __restrict__ partial, int batch, int n, int m, int mpad,
              int d, int dx, int t, int tcols, int chunks, float alpha) {
  constexpr int TP = 8 * NB;                 // columns of the chunk
  constexpr int XS = DS > 0 ? BJ * DS : 4;   // floats of a step's staged points (DS == 0 reads xp)
  extern __shared__ float4 smem4[];
  uint4* vsm = reinterpret_cast<uint4*>(smem4);              // 2 x TP x VQ: split v of a step
  float* xsm = reinterpret_cast<float*>(vsm + 2 * TP * VQ);  // 2 x XS: the step's points

  const size_t b = blockIdx.z;
  const int split = blockIdx.y / chunks;
  const int m16 = mpad / 16;
  x1 += b * n * d;
  xp += b * mpad * dx;
  sqp += b * mpad;
  const int c0 = (blockIdx.y % chunks) * TP;
  vs += (b * tcols + c0) * m16 * 4;
  float* out = partial + (static_cast<size_t>(split) * batch + b) * n * t;
  const int i0 = blockIdx.x * BI;
  const int jbeg = split * MS;
  const int nsteps = (min(m, jbeg + MS) - jbeg + BJ - 1) / BJ;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;

  // the CTA's x1 rows g and g + 8 of each m block: DS > 0 in registers,
  // DS == 0 as pointers into x1 with their squared norms
  float xr[2][2][DS > 0 ? DS : 1];
  const float* rp[2][2];
  float sr[2][2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + 32 * warp + 16 * mb + g + 8 * r;
      if constexpr (DS > 0) {
#pragma unroll
        for (int k = 0; k < DS; ++k)
          xr[mb][r][k] = (row < n && k < d) ? x1[static_cast<size_t>(row) * d + k] : 0.0f;
      } else {
        rp[mb][r] = x1 + static_cast<size_t>(min(row, n - 1)) * d;  // rows past n are never written
        sr[mb][r] = sq_norm(rp[mb][r], d);
      }
    }

  float acc[2][NB][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0.0f;

  // copies of the step at x2 point j0 into buffer buf
  auto stage = [&](int buf, int j0) {
    uint4* dst = vsm + buf * TP * VQ;
    for (int idx = tid; idx < TP * 16; idx += NT) {
      const int c = idx / 16, e = idx % 16;
      cp_async16(dst + c * VQ + e, vs + (static_cast<size_t>(c) * m16 + j0 / 16) * 4 + e);
    }
    if constexpr (DS > 0) {
      for (int idx = tid; idx < BJ * DS / 4; idx += NT)
        cp_async16(xsm + buf * XS + 4 * idx, xp + static_cast<size_t>(j0) * DS + 4 * idx);
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
    const uint4* vb = vsm + buf * TP * VQ;
    const float* xb = xsm + buf * XS;

#pragma unroll 1
    for (int kc = 0; kc < BJ / 16; ++kc) {
      SplitA a[2];
      float xc[4][DS > 0 ? DS : 1];
      const float* cp[4];
      float sc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 16 * kc + frag_col(q, c);
        if constexpr (DS > 0) {
          load_point<DS>(xc[c], xb, col);
        } else {
          cp[c] = xp + static_cast<size_t>(j0 + col) * dx;
          sc[c] = sqp[j0 + col];
        }
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        float d2[2][4];
        if constexpr (DS > 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) d2[r][c] = diff_d2<DS>(xr[mb][r], xc[c]);
        } else {
          quad_d2(rp[mb], sr[mb], cp, sc, d, d2);
        }
        a[mb] = covar_block<COVAR>(d2, alpha);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        // v as B: points 16 kc + 2q (+8) of the step, column 8 nb + g
        const uint4 w = vb[(8 * nb + g) * VQ + 4 * kc + q];
        const SplitB vf = {{w.x, w.y}, {w.z, w.w}};
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          acc3(part, a[mb], vf);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mb][nb][e] += part[e];
        }
      }
    }
    __syncthreads();  // every read of buffer buf is done before it is refilled
  }

#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + 32 * warp + 16 * mb + g + 8 * (e >> 1);
        const int col = c0 + 8 * nb + 2 * q + (e & 1);
        if (row < n && col < t) out[static_cast<size_t>(row) * t + col] = acc[mb][nb][e];
      }
}

template <int COVAR, int NB, int DS>
cudaError_t launch(const float* x1, const Prepared& p, float* partial, int batch, int n, int m, int d, int t,
                   int tcols, float alpha, cudaStream_t stream) {
  const size_t smem = sizeof(uint4) * 2 * 8 * NB * VQ + sizeof(float) * 2 * (DS > 0 ? BJ * DS : 4);
  auto kern = matvec_kernel<COVAR, NB, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int chunks = tcols / (8 * NB);
  const int splits = (m + MS - 1) / MS;
  const dim3 grid((n + BI - 1) / BI, chunks * splits, batch);
  kern<<<grid, NT, smem, stream>>>(x1, p.xp, p.sq, p.vs, partial, batch, n, m, p.mpad, d, p.dx, t, tcols, chunks,
                                   alpha);
  return cudaGetLastError();
}

template <int COVAR, int NB>
cudaError_t by_dims(const float* x1, const Prepared& p, float* out, int batch, int n, int m, int d, int t,
                    int tcols, float alpha, cudaStream_t stream) {
  if (d <= 4) return launch<COVAR, NB, 4>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
  if (d <= 8) return launch<COVAR, NB, 8>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
  return launch<COVAR, NB, 0>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
}

template <int COVAR>
cudaError_t by_chunk(int tp, const float* x1, const Prepared& p, float* out, int batch, int n, int m, int d,
                     int t, int tcols, float alpha, cudaStream_t stream) {
  switch (tp) {
    case 8: return by_dims<COVAR, 1>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
    case 16: return by_dims<COVAR, 2>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
    case 24: return by_dims<COVAR, 3>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
    case 32: return by_dims<COVAR, 4>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
    case 48: return by_dims<COVAR, 6>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
    case 72: return by_dims<COVAR, 9>(x1, p, out, batch, n, m, d, t, tcols, alpha, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_tp(int tp) { return tp == 8 || tp == 16 || tp == 24 || tp == 32 || tp == 48 || tp == 72; }

// rhs columns padded to whole chunks of tp
int padded_columns(int t, int tp) { return (t + tp - 1) / tp * tp; }

}  // namespace

// Bytes of the scratch that kernel_matvec_f32 takes for these shapes.
extern "C" long long kernel_matvec_f32_scratch(int batch, int m, int d, int t, int tp) {
  if (batch < 1 || m < 1 || d < 1 || t < 1 || !valid_tp(tp)) return -1;
  return static_cast<long long>(prepared_bytes(batch, m, d, padded_columns(t, tp)));
}

// x1 (batch, n, d), x2 (batch, m, d), v (batch, m, t), partial (splits,
// batch, n, t) with splits = ceil(m / 4096), the caller summing over splits,
// and scratch of kernel_matvec_f32_scratch bytes; all f32 (scratch 16-byte
// aligned), contiguous, on the device of `stream`.  tp, the columns per CTA,
// is 8, 16, 24, 32, 48 or 72; d <= 128.  Returns the CUDA error of the
// launches (0 when they were accepted).
extern "C" int kernel_matvec_f32(const float* x1, const float* x2, const float* v, float* out, void* scratch,
                                 int batch, int n, int m, int d, int t, int tp, int covar, float alpha,
                                 void* stream) {
  if (n < 1 || m < 1 || t < 1 || d < 1 || d > 128 || batch < 1 || batch > 65535 || !valid_tp(tp) ||
      static_cast<long long>((t + tp - 1) / tp) * ((m + MS - 1) / MS) > 65535 || covar < 0 ||
      covar >= NUM_COVARS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tcols = padded_columns(t, tp);
  Prepared p;
  cudaError_t err = prepare(x2, v, scratch, batch, m, d, t, tcols, s, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (covar) {
    case COVAR_RBF: return by_chunk<COVAR_RBF>(tp, x1, p, out, batch, n, m, d, t, tcols, alpha, s);
    case COVAR_MATERN52: return by_chunk<COVAR_MATERN52>(tp, x1, p, out, batch, n, m, d, t, tcols, alpha, s);
    case COVAR_MATERN32: return by_chunk<COVAR_MATERN32>(tp, x1, p, out, batch, n, m, d, t, tcols, alpha, s);
    case COVAR_MATERN12: return by_chunk<COVAR_MATERN12>(tp, x1, p, out, batch, n, m, d, t, tcols, alpha, s);
    default: return by_chunk<COVAR_RQ>(tp, x1, p, out, batch, n, m, d, t, tcols, alpha, s);
  }
}
