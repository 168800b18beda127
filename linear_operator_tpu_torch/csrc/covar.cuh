// Stationary covariances k(d2) of inputs pre-scaled by the lengthscale, and
// their derivatives dk/d(d2), for the K2 (kernel_weighted.cu) and K4
// (kernel_build_sym.cu) kernels; the covariance ids, which K1 and K3 share
// (their k(d2) is acc3_mma.cuh's covar_fast); axpy_row for K5
// (kernel_matvec_cached.cu).  The formulas, and the
// sqrt(d2 + 1e-30) convention of the Matern kernels, are those of ops/rbf.py's
// plain versions (TILE_COVARS).
#pragma once

#include <cuda_runtime.h>

// Covariance ids, the covar_id of each ops/rbf.py TILE_COVARS entry.
#define COVAR_RBF 0
#define COVAR_MATERN52 1
#define COVAR_MATERN32 2
#define COVAR_MATERN12 3
#define COVAR_RQ 4
#define NUM_COVARS 5

template <int COVAR>
__device__ __forceinline__ float covar_fn(float d2, float alpha) {
  if (COVAR == COVAR_RBF) {
    return expf(-0.5f * d2);
  } else if (COVAR == COVAR_MATERN52) {
    const float sd = 2.23606797749979f * sqrtf(d2 + 1e-30f);
    return (1.0f + sd + (5.0f / 3.0f) * d2) * expf(-sd);
  } else if (COVAR == COVAR_MATERN32) {
    const float sd = 1.7320508075688772f * sqrtf(d2 + 1e-30f);
    return (1.0f + sd) * expf(-sd);
  } else if (COVAR == COVAR_MATERN12) {
    return expf(-sqrtf(d2 + 1e-30f));
  } else {
    // rational quadratic (1 + d2 / (2 alpha))^-alpha
    return expf(-alpha * log1pf(d2 / (2.0f * alpha)));
  }
}

// dk/d(d2), the weight of the chain rule through the squared distance (K2).
template <int COVAR>
__device__ __forceinline__ float dcovar_fn(float d2, float alpha) {
  if (COVAR == COVAR_RBF) {
    return -0.5f * expf(-0.5f * d2);
  } else if (COVAR == COVAR_MATERN52) {
    // -(5/6)(1 + sqrt5 d) e^{-sqrt5 d}
    const float sd = 2.23606797749979f * sqrtf(d2 + 1e-30f);
    return -(5.0f / 6.0f) * (1.0f + sd) * expf(-sd);
  } else if (COVAR == COVAR_MATERN32) {
    // -(3/2) e^{-sqrt3 d}
    return -1.5f * expf(-1.7320508075688772f * sqrtf(d2 + 1e-30f));
  } else if (COVAR == COVAR_MATERN12) {
    // -e^{-d} / (2 d), singular at d = 0: a (near-)coincident pair gets
    // weight 0 (the plain version's and the JAX package's convention)
    if (!(d2 > 1e-12f)) return 0.0f;
    const float r = sqrtf(d2 + 1e-30f);
    return -expf(-r) / (2.0f * r);
  } else {
    // -(1/2) (1 + d2 / (2 alpha))^(-alpha - 1)
    return -0.5f * expf((-alpha - 1.0f) * log1pf(d2 / (2.0f * alpha)));
  }
}

// Squared distance over DS (4 or 8) dimensions, zero-padded past d, by
// differences: exact in f32, as the plain version's d <= 8 branch.
template <int DS>
__device__ __forceinline__ float sq_dist_diff(const float (&a)[DS], const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float d2 = 0.0f;
#pragma unroll
  for (int q = 0; q < DS / 4; ++q) {
    const float4 w = b4[q];
    const float e0 = a[4 * q + 0] - w.x;
    const float e1 = a[4 * q + 1] - w.y;
    const float e2 = a[4 * q + 2] - w.z;
    const float e3 = a[4 * q + 3] - w.w;
    d2 = fmaf(e0, e0, d2);
    d2 = fmaf(e1, e1, d2);
    d2 = fmaf(e2, e2, d2);
    d2 = fmaf(e3, e3, d2);
  }
  return d2;
}

// acc[c] += k * v[c] for c < TP, with v read as float4 from shared memory
// (every lane of a warp reads the same v, so each load is a broadcast).
template <int TP>
__device__ __forceinline__ void axpy_row(float (&acc)[TP], float k, const float* v) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
  for (int q = 0; q < TP / 4; ++q) {
    const float4 w = v4[q];
    acc[4 * q + 0] = fmaf(k, w.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(k, w.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(k, w.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(k, w.w, acc[4 * q + 3]);
  }
}
