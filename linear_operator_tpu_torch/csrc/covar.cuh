// Stationary covariances k(d2) of inputs pre-scaled by the lengthscale, for
// K4 (kernel_build_sym.cu), and the covariance ids that every kernel switches
// on (K1, K2, K3 evaluate k and dk/d(d2) through acc3_mma.cuh's covar_fast
// and dcovar_fast).  The formulas, and the sqrt(d2 + 1e-30) convention of the
// Matern kernels, are those of ops/rbf.py's plain versions (TILE_COVARS).
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
