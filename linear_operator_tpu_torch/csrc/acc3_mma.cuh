// The 3-pass bf16 contraction of the TPU kernels on Hopper's tensor cores,
// shared by K1 (kernel_matvec.cu) and K3 (kernel_matvec_sym.cu).
//
// The Pallas kernels contract a kernel tile with v through _dot_acc3
// (linear_operator_tpu/ops/rbf.py): each f32 operand splits into hi =
// bf16(a) and lo = bf16(a - hi), both rounded to nearest even, and the
// product is a_hi b_hi + a_hi b_lo + a_lo b_hi with f32 accumulation (what
// Precision.HIGH computes).  Here each of the three is one
// mma.sync.m16n8k16 with bf16 operands and an f32 accumulator.  Neither TF32
// nor a single bf16 pass is used: either perturbs the mat-vec by ~1e-3 to
// 1e-2 relative, which stalls CG.
//
// Fragment layouts of m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..2q+1),
//                           a2 = (g, 2q+8..2q+9), a3 = (g+8, 2q+8..2q+9);
//   B (16 x 8, k x n):      b0 = (2q..2q+1, g), b1 = (2q+8..2q+9, g);
//   C (16 x 8, f32):        c0 = (g, 2q), c1 = (g, 2q+1), c2 = (g+8, 2q),
//                           c3 = (g+8, 2q+1).
// Each 32-bit register holds two bf16, the lower k index in the low half.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "covar.cuh"

// bf16x2 of (a, b), round to nearest even: a in the low half, b in the high.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
  return d;
}

// The f32 values of the low and the high bf16 of a packed pair.
__device__ __forceinline__ float bf16_low(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_high(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// The split of (a, b): hi = bf16x2(a, b), lo = bf16x2(a - hi_a, b - hi_b).
// a - hi_a is exact in f32, as in _dot_acc3.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  lo = pack_bf16x2(a - bf16_low(hi), b - bf16_high(hi));
}

// c += A B, one m16n8k16 product with bf16 operands and f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its hi and lo bf16 parts.
struct SplitA {
  uint32_t hi[4];
  uint32_t lo[4];
};

// A B fragment (v) split into its hi and lo bf16 parts.
struct SplitB {
  uint32_t hi[2];
  uint32_t lo[2];
};

// c += A_hi B_hi + A_hi B_lo + A_lo B_hi: one _dot_acc3 step.
__device__ __forceinline__ void acc3(float (&c)[4], const SplitA& a, const SplitB& b) {
  mma_bf16(c, a.hi, b.hi[0], b.hi[1]);
  mma_bf16(c, a.hi, b.lo[0], b.lo[1]);
  mma_bf16(c, a.lo, b.hi[0], b.hi[1]);
}

// The transpose of an 8 x 8 b16 matrix held one row per quad, across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}

// The A fragment of the transposed 16 x 16 block: its 8 x 8 quarters swap
// across the diagonal, and each is transposed.
__device__ __forceinline__ void transpose_a(const uint32_t (&a)[4], uint32_t (&at)[4]) {
  at[0] = movmatrix_trans(a[0]);
  at[1] = movmatrix_trans(a[2]);
  at[2] = movmatrix_trans(a[1]);
  at[3] = movmatrix_trans(a[3]);
}

// A 16 x 16 block of kernel values in A-fragment order, k[r][c] with r = 0
// for row g and 1 for row g + 8, c = 0..3 for columns 2q, 2q+1, 2q+8, 2q+9,
// split into hi and lo.
__device__ __forceinline__ SplitA split_block(const float (&k)[2][4]) {
  SplitA a;
  split_bf16x2(k[0][0], k[0][1], a.hi[0], a.lo[0]);
  split_bf16x2(k[1][0], k[1][1], a.hi[1], a.lo[1]);
  split_bf16x2(k[0][2], k[0][3], a.hi[2], a.lo[2]);
  split_bf16x2(k[1][2], k[1][3], a.hi[3], a.lo[3]);
  return a;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// k(d2) of covar.cuh's covar_fn, with the exponent as one ex2.approx on an
// argument pre-scaled by log2(e) (and sqrt, log as their .approx forms):
// a relative error of a few 2^-23, far below the 2^-16 that the bf16 split
// leaves.  Only K1 and K3 call it; covar_fn, which K4 needs bit for bit
// beside its plain version, stays as it is.  alpha is the rational
// quadratic's.
template <int COVAR>
__device__ __forceinline__ float covar_fast(float d2, float alpha) {
  constexpr float LOG2E = 1.4426950408889634f;
  if (COVAR == COVAR_RBF) {
    return ex2_approx(d2 * (-0.5f * LOG2E));
  } else if (COVAR == COVAR_MATERN52) {
    const float sd = 2.23606797749979f * sqrt_approx(d2 + 1e-30f);
    return (1.0f + sd + (5.0f / 3.0f) * d2) * ex2_approx(-LOG2E * sd);
  } else if (COVAR == COVAR_MATERN32) {
    const float sd = 1.7320508075688772f * sqrt_approx(d2 + 1e-30f);
    return (1.0f + sd) * ex2_approx(-LOG2E * sd);
  } else if (COVAR == COVAR_MATERN12) {
    return ex2_approx(-LOG2E * sqrt_approx(d2 + 1e-30f));
  } else {
    // (1 + d2 / (2 alpha))^-alpha
    return ex2_approx(-alpha * lg2_approx(1.0f + d2 / (2.0f * alpha)));
  }
}

// Column c = 0..3 of a thread's A-fragment entries: 2q, 2q+1, 2q+8, 2q+9.
__device__ __forceinline__ int frag_col(int q, int c) { return 2 * q + (c & 1) + 8 * (c >> 1); }

// Squared distance over DS dimensions zero-padded past d, by differences:
// exact in f32, as the plain version's d <= 8 branch.
template <int DS>
__device__ __forceinline__ float diff_d2(const float (&a)[DS], const float (&b)[DS]) {
  float d2 = 0.0f;
#pragma unroll
  for (int k = 0; k < DS; ++k) {
    const float e = a[k] - b[k];
    d2 = fmaf(e, e, d2);
  }
  return d2;
}

// Point p of a [point][DS] array in shared memory, into registers.
template <int DS>
__device__ __forceinline__ void load_point(float (&a)[DS], const float* xs, int p) {
  const float4* x4 = reinterpret_cast<const float4*>(xs + p * DS);
#pragma unroll
  for (int k = 0; k < DS / 4; ++k) {
    const float4 w = x4[k];
    a[4 * k + 0] = w.x;
    a[4 * k + 1] = w.y;
    a[4 * k + 2] = w.z;
    a[4 * k + 3] = w.w;
  }
}

// Squared distances of d > 8 for a thread's 2 x 4 fragment entries: the
// quadratic form sq_r + sq_c - 2 x_r.x_c, clamped at 0, with the inner
// products in one fixed FMA order (k ascending from 0), the order in which
// the squared norms sq were formed, so a point's distance to itself is 0.
// xr[r] and xc[c] point to rows of d floats in shared memory.
__device__ __forceinline__ void quad_d2(const float* (&xr)[2], const float (&sr)[2], const float* (&xc)[4],
                                        const float (&sc)[4], int d, float (&d2)[2][4]) {
  float inner[2][4] = {};
  for (int k = 0; k < d; ++k) {
    const float a0 = xr[0][k], a1 = xr[1][k];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float b = xc[c][k];
      inner[0][c] = fmaf(a0, b, inner[0][c]);
      inner[1][c] = fmaf(a1, b, inner[1][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) d2[r][c] = fmaxf(sr[r] + sc[c] - 2.0f * inner[r][c], 0.0f);
}

// The squared norm of a row of d floats, in quad_d2's FMA order.
__device__ __forceinline__ float sq_norm(const float* a, int d) {
  float s = 0.0f;
  for (int k = 0; k < d; ++k) s = fmaf(a[k], a[k], s);
  return s;
}

// k(d2) of a thread's 2 x 4 fragment entries, split into an A fragment.
template <int COVAR>
__device__ __forceinline__ SplitA covar_block(const float (&d2)[2][4], float alpha) {
  float k[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) k[r][c] = covar_fast<COVAR>(d2[r][c], alpha);
  return split_block(k);
}

// ---------------------------------------------------------------------------
// The prepass of K1 and K3: their contracted operand in the layout the
// kernels stage with cp.async, so that a staged step costs a few 16-byte
// copies and no arithmetic.
//  - xp (batch, mpad, dx): the points zero-padded to mpad (a multiple of
//    PAD_POINTS) rows of dx = 4, 8 (d <= 8) or d rounded up to 4 floats, and
//    sq (batch, mpad) their squared norms in sq_norm's FMA order;
//  - vs (batch, tcols, mpad / 16, 4) uint4: v split into bf16 B-fragment
//    words.  For column c, 16-point chunk s and quad q the four words are
//    {hi, hi', lo, lo'} of the point pairs (16 s + 2q, +1) and (16 s + 2q + 8,
//    +9), so one 16-byte load gives a thread its whole split B fragment.
//    Zero past m and past t: padded points and columns add nothing.
// ---------------------------------------------------------------------------

constexpr int PAD_POINTS = 128;

inline int padded_dim(int d) { return d <= 4 ? 4 : d <= 8 ? 8 : (d + 3) / 4 * 4; }
inline int padded_points(int m) { return (m + PAD_POINTS - 1) / PAD_POINTS * PAD_POINTS; }

// The prepared operand: pointers into the caller's scratch.
struct Prepared {
  const float* xp;
  const float* sq;
  const uint4* vs;
  int mpad;
  int dx;
};

// Bytes of scratch the prepass of (batch, m, d) points and t columns,
// padded to tcols, needs.
inline size_t prepared_bytes(int batch, int m, int d, int tcols) {
  const size_t mpad = padded_points(m);
  return sizeof(float) * batch * mpad * (padded_dim(d) + 1) + sizeof(uint4) * batch * tcols * (mpad / 16) * 4;
}

static __global__ void pad_points_kernel(const float* __restrict__ x, float* __restrict__ xp,
                                         float* __restrict__ sq, int batch, int m, int d, int mpad, int dx) {
  const long long total = static_cast<long long>(batch) * mpad;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(idx / mpad), p = static_cast<int>(idx % mpad);
    const float* row = x + (static_cast<size_t>(b) * m + p) * d;
    float* dst = xp + idx * dx;
    float s = 0.0f;
    for (int k = 0; k < dx; ++k) {
      const float a = (p < m && k < d) ? row[k] : 0.0f;
      dst[k] = a;
      if (k < d) s = fmaf(a, a, s);
    }
    sq[idx] = s;
  }
}

static __global__ void split_v_kernel(const float* __restrict__ v, uint4* __restrict__ vs, int batch, int m,
                                      int t, int tcols, int m16) {
  const long long total = static_cast<long long>(batch) * m16 * 4 * tcols;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    // c fastest, so that neighbouring threads read neighbouring floats of v
    const int c = static_cast<int>(idx % tcols);
    long long r = idx / tcols;
    const int q = static_cast<int>(r % 4);
    r /= 4;
    const int s = static_cast<int>(r % m16), b = static_cast<int>(r / m16);
    const float* vb = v + static_cast<size_t>(b) * m * t;
    auto at = [&](int p) { return (p < m && c < t) ? vb[static_cast<size_t>(p) * t + c] : 0.0f; };
    const int p = 16 * s + 2 * q;
    uint4 w;
    split_bf16x2(at(p), at(p + 1), w.x, w.z);
    split_bf16x2(at(p + 8), at(p + 9), w.y, w.w);
    vs[((static_cast<size_t>(b) * tcols + c) * m16 + s) * 4 + q] = w;
  }
}

// Runs the prepass of x (batch, m, d) and v (batch, m, t) into `scratch`
// (prepared_bytes(batch, m, d, tcols), 16-byte aligned) on `stream`.
inline cudaError_t prepare(const float* x, const float* v, void* scratch, int batch, int m, int d, int t,
                           int tcols, cudaStream_t stream, Prepared& out) {
  out.mpad = padded_points(m);
  out.dx = padded_dim(d);
  float* xp = static_cast<float*>(scratch);
  float* sq = xp + static_cast<size_t>(batch) * out.mpad * out.dx;
  uint4* vs = reinterpret_cast<uint4*>(sq + static_cast<size_t>(batch) * out.mpad);
  out.xp = xp;
  out.sq = sq;
  out.vs = vs;
  const int threads = 256;
  auto blocks = [](long long work) { return static_cast<unsigned>(work / threads + 1 < 8192 ? work / threads + 1 : 8192); };
  const long long np = static_cast<long long>(batch) * out.mpad;
  pad_points_kernel<<<blocks(np), threads, 0, stream>>>(x, xp, sq, batch, m, d, out.mpad, out.dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nv = np / 16 * 4 * tcols;
  split_v_kernel<<<blocks(nv), threads, 0, stream>>>(v, vs, batch, m, t, tcols, out.mpad / 16);
  return cudaGetLastError();
}

// cp.async of 16 bytes from global to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

// Waits until at most the newest group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;"); }
