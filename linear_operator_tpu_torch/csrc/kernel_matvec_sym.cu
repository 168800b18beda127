// K3: y = K v for the symmetric stationary kernel matrix K_ij = k(|x_i - x_j|^2).
//
// Replaces the Pallas TPU kernel _pallas_matvec_sym / _make_sym_matvec_kernel
// (its acc3 mode) of linear_operator_tpu/ops/rbf.py (wrapper kernel_matvec_sym).
//
// What bounds it on an H100: operations.  It reads x (n, d) and v (n, t) and
// writes y (n, t), a few MB, but forms n^2 / 2 kernel entries, each costing
// the distance and exponent (3d + 1 f32 operations and one special-function
// result) and 4t products (row and column contractions) in each of the three
// bf16 passes of the TPU kernel's _dot_acc3.  At n = 1e5, d = 3, t = 11: the
// formation takes 0.75 ms at 67 TFLOP/s, the products 0.67 ms on the bf16
// tensor cores, the exponents ~1.3 ms at 16 per SM and clock.
//
// Design.  The contraction runs on the tensor cores as the TPU kernel's
// (acc3_mma.cuh): mma.sync m16n8k16, bf16 operands split hi/lo, three
// products into one f32 accumulator; t is padded to TN n8 blocks (8 or 16
// columns, padded columns carry v = 0).  No kernel tile goes through shared
// memory:
//  - A CTA of 4 warps owns a row block of B = 128 points; warp w forms the
//    entries of its 32 rows (two m16 blocks) of each 128 x 128 tile directly
//    in registers, in the A-fragment layout.
//  - Row contribution K_IJ v_J: the fragments are A, v_J (staged in shared
//    memory as its split B-fragment words) is B.  It accumulates in registers
//    across every tile of the row block and is added to y once.
//  - Column contribution K_IJ^T v_I of an off-diagonal tile: the same
//    registers, transposed with movmatrix, are A; v_I is B, held in registers
//    for the whole row block.  The four warps' partials are summed in shared
//    memory and added to y with one float4 atomicAdd per 4 columns and rhs.
//  - A diagonal tile (bj == bi) holds its whole symmetric block and adds its
//    row contribution only, as the TPU kernel does.
//  - Schedule: the upper-triangle tile pairs (bi <= bj) in row-major order
//    are cut into one equal share per CTA, one wave of CTAs (persistent); a
//    CTA walks its share, adding its row sums to y whenever its row block
//    changes.
//  - Staging: a prepass (acc3_mma.cuh) pads x and splits v into bf16 hi and
//    lo B-fragment words once per launch; each column block's points and
//    words are copied with cp.async, double-buffered, so the next tile's
//    copies overlap this tile's work.
//  - Each tile's row products go to fresh accumulators that are then added
//    to the row sums (f32, round to nearest): the tensor cores add into their
//    accumulator with truncation, which over a long chain of large sums
//    drifts ~1e-5 relative.
// y is carried transposed, (t, ldo) with ldo = n rounded up to 4 (16-byte
// aligned rows for the vector atomics), zeroed by the caller; rows and
// columns past n (zero v) add nothing to y below n.
//
// Reproducibility: the order in which CTAs add to y varies from run to run,
// so two runs on the same inputs may differ in the last bits of y.
//
// Distances: d <= 8 sums squared differences over d zero-padded to DS = 4 or
// 8 (exact in f32); d > 8 (DS = 0) uses the quadratic form sq_i + sq_j -
// 2 x_i.x_j with f32 FMAs in one fixed order, clamped at 0, so a point's
// distance to itself is exactly 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "acc3_mma.cuh"

namespace {

constexpr int B = 128;                // tile edge: points of a row block and of a column block
constexpr int NW = 4;                 // warps per CTA; warp w owns rows [32 w, 32 w + 32) of a row block
constexpr int NT = 32 * NW;           // threads per CTA (== B)
constexpr int TC = 16;                // rhs columns, padded, at most
constexpr int CS = B + 4;             // row stride of a warp's column partials in floats
constexpr int VQ = 4 * (B / 16) + 4;  // uint4 per column of a staged tile (+4: conflict-free loads)

inline __host__ __device__ int out_stride(int n) { return (n + 3) & ~3; }

template <int COVAR, int TN, int DS>
__global__ void __launch_bounds__(NT, 1)
sym_matvec_kernel(const float* __restrict__ xp, const float* __restrict__ sqp, const uint4* __restrict__ vs,
                  float* __restrict__ out_t, int n, int npad, int dx, int d, int t, int nblk, long long npairs,
                  float alpha) {
  constexpr int TP = 8 * TN;                // rhs columns, padded
  constexpr int XS = DS > 0 ? B * DS : 4;   // floats of a tile's staged points (DS == 0 reads xp)
  extern __shared__ float4 smem4[];
  float* cpart = reinterpret_cast<float*>(smem4);                  // NW x TC x CS column partials
  uint4* vsm = reinterpret_cast<uint4*>(cpart + NW * TC * CS);     // 2 x TP x VQ: split v_J
  float* xsm = reinterpret_cast<float*>(vsm + 2 * TP * VQ);        // 2 x XS: x_J

  const size_t b = blockIdx.y;
  const int m16 = npad / 16;
  xp += b * npad * dx;
  sqp += b * npad;
  vs += b * TP * m16 * 4;
  const int ldo = out_stride(n);
  out_t += b * t * ldo;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;

  // this CTA's share [p0, p1) of the tile pairs; pair p0 is (bi, bj)
  const long long p0 = npairs * blockIdx.x / gridDim.x;
  const long long p1 = npairs * (blockIdx.x + 1) / gridDim.x;
  auto first_pair = [nblk](long long r) { return r * nblk - r * (r - 1) / 2; };
  int lo = 0, hi = nblk - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first_pair(mid) <= p0) lo = mid; else hi = mid - 1;
  }
  int bi = lo;
  int bj = bi + static_cast<int>(p0 - first_pair(bi));

  float acc_r[2][TN][4];           // row sums: m block, n block, C fragment
  SplitB vi[2][TN];                // v_I as B: rows 2q.. of m block mb, column g of n block nb
  float xr[2][2][DS > 0 ? DS : 1];  // DS > 0: rows g and g + 8 of each m block
  const float* rp[2][2];           // DS == 0: those rows in xp, and their squared norms
  float sr[2][2];
  int cur = -1;                    // the row block in the registers

  auto flush_rows = [&]() {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < TN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = cur * B + 32 * warp + 16 * mb + g + 8 * (e >> 1);
          const int col = 8 * nb + 2 * q + (e & 1);
          if (row < n && col < t) atomicAdd(out_t + static_cast<size_t>(col) * ldo + row, acc_r[mb][nb][e]);
        }
  };

  auto load_rows = [&]() {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int rb = bi * B + 32 * warp + 16 * mb;
#pragma unroll
      for (int nb = 0; nb < TN; ++nb) {
        const uint4 w = vs[(static_cast<size_t>(8 * nb + g) * m16 + rb / 16) * 4 + q];
        vi[mb][nb] = {{w.x, w.y}, {w.z, w.w}};
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_r[mb][nb][e] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rb + g + 8 * r;
        if constexpr (DS > 0) {
          const float4* x4 = reinterpret_cast<const float4*>(xp + static_cast<size_t>(row) * DS);
#pragma unroll
          for (int k = 0; k < DS / 4; ++k) {
            const float4 u = x4[k];
            xr[mb][r][4 * k + 0] = u.x;
            xr[mb][r][4 * k + 1] = u.y;
            xr[mb][r][4 * k + 2] = u.z;
            xr[mb][r][4 * k + 3] = u.w;
          }
        } else {
          rp[mb][r] = xp + static_cast<size_t>(row) * dx;
          sr[mb][r] = sqp[row];
        }
      }
    }
    cur = bi;
  };

  // copies of column block bj into buffer buf
  auto stage = [&](int buf, int bj) {
    uint4* dst = vsm + buf * TP * VQ;
    for (int idx = tid; idx < TP * 32; idx += NT) {
      const int c = idx / 32, e = idx % 32;
      cp_async16(dst + c * VQ + e, vs + (static_cast<size_t>(c) * m16 + 8 * bj) * 4 + e);
    }
    if constexpr (DS > 0) {
      for (int idx = tid; idx < B * DS / 4; idx += NT)
        cp_async16(xsm + buf * XS + 4 * idx, xp + static_cast<size_t>(bj) * B * DS + 4 * idx);
    }
  };

  if (p0 < p1) stage(0, bj);
  cp_async_commit();
  for (long long p = p0; p < p1; ++p) {
    const int buf = static_cast<int>((p - p0) & 1);
    int nbi = bi, nbj = bj + 1;  // the next tile pair
    if (nbj == nblk) {
      ++nbi;
      nbj = nbi;
    }
    if (p + 1 < p1) stage(buf ^ 1, nbj);
    cp_async_commit();
    if (bi != cur) {
      if (cur >= 0) flush_rows();
      load_rows();
    }
    cp_async_wait_prior();
    __syncthreads();  // this tile's copies, every thread's, have landed

    const int j0 = bj * B;
    const bool diag = bj == bi;
    const uint4* vb = vsm + buf * TP * VQ;
    const float* xb = xsm + buf * XS;
    float* cw = cpart + warp * TC * CS;
    float acc_t[2][TN][4];  // the tile's row sums, added to acc_r at its end
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < TN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_t[mb][nb][e] = 0.0f;

#pragma unroll 2
    for (int kc = 0; kc < B / 16; ++kc) {
      // v_J as B: points 16 kc + 2q (+8) of the block, column 8 nb + g
      SplitB vj[TN];
#pragma unroll
      for (int nb = 0; nb < TN; ++nb) {
        const uint4 w = vb[(8 * nb + g) * VQ + 4 * kc + q];
        vj[nb] = {{w.x, w.y}, {w.z, w.w}};
      }
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
      float acc_c[TN][4];
#pragma unroll
      for (int nb = 0; nb < TN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_c[nb][e] = 0.0f;

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
        const SplitA a = covar_block<COVAR>(d2, alpha);
#pragma unroll
        for (int nb = 0; nb < TN; ++nb) acc3(acc_t[mb][nb], a, vj[nb]);
        if (!diag) {
          SplitA at;
          transpose_a(a.hi, at.hi);
          transpose_a(a.lo, at.lo);
#pragma unroll
          for (int nb = 0; nb < TN; ++nb) acc3(acc_c[nb], at, vi[mb][nb]);
        }
      }
      if (!diag) {
        // C fragment of acc_c: rows = columns 16 kc + g (+8) of the block,
        // columns = rhs 8 nb + 2q (+1); stored [rhs][column]
#pragma unroll
        for (int nb = 0; nb < TN; ++nb) {
          float* dst = cw + (8 * nb + 2 * q) * CS + 16 * kc + g;
          dst[0] = acc_c[nb][0];
          dst[CS] = acc_c[nb][1];
          dst[8] = acc_c[nb][2];
          dst[CS + 8] = acc_c[nb][3];
        }
      }
    }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < TN; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_r[mb][nb][e] += acc_t[mb][nb][e];

    if (!diag) {
      __syncthreads();  // every warp's column partials are in shared memory
      for (int idx = tid; idx < t * (B / 4); idx += NT) {
        const int c = idx / (B / 4), j4 = idx % (B / 4);
        if (j0 + 4 * j4 >= n) continue;
        float4 s = reinterpret_cast<const float4*>(cpart + c * CS)[j4];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
          const float4 u = reinterpret_cast<const float4*>(cpart + (w * TC + c) * CS)[j4];
          s.x += u.x;
          s.y += u.y;
          s.z += u.z;
          s.w += u.w;
        }
        atomicAdd(reinterpret_cast<float4*>(out_t + static_cast<size_t>(c) * ldo + j0) + j4, s);
      }
    }
    __syncthreads();  // every read of buffer buf and of the partials is done
    bi = nbi;
    bj = nbj;
  }
  if (cur >= 0) flush_rows();
}

template <int COVAR, int TN, int DS>
cudaError_t launch(const Prepared& p, float* out_t, int batch, int n, int d, int t, float alpha,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * NW * TC * CS + sizeof(uint4) * 2 * 8 * TN * VQ +
                      sizeof(float) * 2 * (DS > 0 ? B * DS : 4);
  auto kern = sym_matvec_kernel<COVAR, TN, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem)) != cudaSuccess) return err;
  const int nblk = (n + B - 1) / B;
  const long long npairs = static_cast<long long>(nblk) * (nblk + 1) / 2;
  // one wave: each CTA takes an equal share of the tile pairs
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(static_cast<unsigned>(npairs < wave ? npairs : wave), batch);
  kern<<<grid, NT, smem, stream>>>(p.xp, p.sq, p.vs, out_t, n, p.mpad, p.dx, d, t, nblk, npairs, alpha);
  return cudaGetLastError();
}

template <int COVAR, int TN>
cudaError_t by_dims(const Prepared& p, float* out_t, int batch, int n, int d, int t, float alpha,
                    cudaStream_t stream) {
  if (d <= 4) return launch<COVAR, TN, 4>(p, out_t, batch, n, d, t, alpha, stream);
  if (d <= 8) return launch<COVAR, TN, 8>(p, out_t, batch, n, d, t, alpha, stream);
  return launch<COVAR, TN, 0>(p, out_t, batch, n, d, t, alpha, stream);
}

template <int COVAR>
cudaError_t by_columns(const Prepared& p, float* out_t, int batch, int n, int d, int t, float alpha,
                       cudaStream_t stream) {
  if (t <= 8) return by_dims<COVAR, 1>(p, out_t, batch, n, d, t, alpha, stream);
  return by_dims<COVAR, 2>(p, out_t, batch, n, d, t, alpha, stream);
}

int padded_columns(int t) { return t <= 8 ? 8 : 16; }

}  // namespace

// Bytes of the scratch that kernel_matvec_sym_f32 takes for these shapes.
extern "C" long long kernel_matvec_sym_f32_scratch(int batch, int n, int d, int t) {
  if (batch < 1 || n < 1 || d < 1 || t < 1 || t > TC) return -1;
  return static_cast<long long>(prepared_bytes(batch, n, d, padded_columns(t)));
}

// x (batch, n, d), v (batch, n, t), out_t (batch, t, ldo) with ldo = n
// rounded up to a multiple of 4, zeroed by the caller (columns past n are
// scratch), and scratch of kernel_matvec_sym_f32_scratch bytes; all f32
// (scratch 16-byte aligned), contiguous, on the device of `stream`.
// 1 <= t <= 16, batch <= 65535 (grid.y: ops/rbf.py launches a larger batch in
// groups).  Returns the CUDA error of the launches (0 when
// they were accepted).
extern "C" int kernel_matvec_sym_f32(const float* x, const float* v, float* out_t, void* scratch, int batch,
                                     int n, int d, int t, int covar, float alpha, void* stream) {
  if (t < 1 || t > TC || d < 1 || n < 1 || batch < 1 || batch > 65535 || covar < 0 ||
      covar >= NUM_COVARS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Prepared p;
  cudaError_t err = prepare(x, v, scratch, batch, n, d, t, padded_columns(t), s, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (covar) {
    case COVAR_RBF: return by_columns<COVAR_RBF>(p, out_t, batch, n, d, t, alpha, s);
    case COVAR_MATERN52: return by_columns<COVAR_MATERN52>(p, out_t, batch, n, d, t, alpha, s);
    case COVAR_MATERN32: return by_columns<COVAR_MATERN32>(p, out_t, batch, n, d, t, alpha, s);
    case COVAR_MATERN12: return by_columns<COVAR_MATERN12>(p, out_t, batch, n, d, t, alpha, s);
#ifdef LO_USER_COVAR
    case COVAR_USER: return by_columns<COVAR_USER>(p, out_t, batch, n, d, t, alpha, s);
#endif
    default: return by_columns<COVAR_RQ>(p, out_t, batch, n, d, t, alpha, s);
  }
}
