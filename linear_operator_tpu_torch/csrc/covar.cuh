// The covariance ids that every kernel switches on: the stationary
// covariances k(d2) of inputs pre-scaled by the lengthscale, which K1, K3 and
// K4 evaluate through acc3_mma.cuh's covar_fast and K2 (dk/d(d2)) through its
// dcovar_fast.  The formulas, and the sqrt(d2 + 1e-30) convention of the
// Matern kernels, are those of ops/rbf.py's plain versions (TILE_COVARS).
#pragma once

#include <cuda_runtime.h>

// Covariance ids, the covar_id of each ops/rbf.py TILE_COVARS entry.
#define COVAR_RBF 0
#define COVAR_MATERN52 1
#define COVAR_MATERN32 2
#define COVAR_MATERN12 3
#define COVAR_RQ 4
// A covariance registered at run time with CUDA bodies
// (ops/rbf.py register_tile_covar): its builds of the sources are passed a
// generated header (nvcc -include, _build.covar_header) that defines
// LO_USER_COVAR and user_covar(d2), user_dcovar(d2).  The default builds
// have none: NUM_COVARS leaves the id out and the stubs below are never
// instantiated.
#define COVAR_USER 5
#ifdef LO_USER_COVAR
#define NUM_COVARS 6
#else
#define NUM_COVARS 5
__device__ __forceinline__ float user_covar(float) { return 0.0f; }
__device__ __forceinline__ float user_dcovar(float) { return 0.0f; }
#endif
