#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (linear_operator_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
 1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
 2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
 3. hold every kernel (K1, K3, K2) against its plain PyTorch version on the
    card, for each covariance at small shapes (each against both plain
    versions: full precision, and kernel_matvec_acc3_plain or
    kernel_weighted_acc3_plain, their own 3-pass bf16 arithmetic), and the
    backwards of K1 and K3 against autograd through the plain version; K1,
    K2, K3 and K4 at d = 200, K1 and K3 at a batch of 65537 (two launches
    each); then each RBF kernel at the shapes of the main path, timed with
    CUDA events beside its bounds, K3's symmetry, and K2 at t = 201 (two
    launches, 128 + 73 columns);
    3c. the bf16 tile cache: K4 and K5 against their plain versions for each
    covariance (K5 on K4's own tiles), then both at N = 100,000, tile 1024,
    timed beside their bounds (K4 over 5 launches, K5 at t = 11 and t = 1),
    K5's symmetry, and as measured rates (references, not bounds) one
    write-only pass over a tensor of the cache's size (fill_) beside K4 and
    one read-only pass over the cache (torch.amax) beside K5;
 4. check a small exact-GP MLL against the CPU run of the same model;
 5. the main path, through the entry points a user calls: the exact-GP
    negative MLL at N = 100,000, d = 3 with the benchmark's settings (K3 must
    launch once per CG iteration), then the posterior at N = 100,000, m = 64
    query points (K1 must launch); each is held against the plain path on
    the card on the same probes;
    5b. neg_mll under the default settings (the rank-15 pivoted-Cholesky
    preconditioner) at the model's initial noise, reported beside the plain
    path and an f64 run, with each f32 path's distance to the f64 one as run
    and with CG to 1e-2; at noise 1.0 held against the plain path;
 6. the training step on the main path: neg_mll(...).backward() at the same
    size (the backward runs no CG, and must make two K2 launches and one K3
    launch, the bilinear form's own mat-vec), held against the plain path's
    gradients on the same probes, then three Adam steps;
    6b. the posterior backward at N = 100,000, m = 200 query points:
    (sum(mean) + sum(var)).backward(), whose two K2 calls of 201 columns must
    make two launches each; at N = 20,000 with CG run to 1e-5, its gradient
    held at noise 1.0 against the plain path and against the exact gradient
    (f64, Cholesky): no further from it than the plain f32 path, plus
    PATH_RTOL; at noise 0.127 reported so, and held so with K1's launches in
    full precision (K2's chunked launches kept);
 8. the tile-cache path at N = 100,000, noise 1.0: a kernel operator with
    matvec_closure_impl=rbf_fused_closure, through inv_quad_logdet and
    solve.  (a) |bf16(K) - K|_2 by power iteration; (b) the training step
    (forward: one K4 launch, one K5 launch per CG iteration, nothing else;
    backward: two K2 launches and one K3 launch); (c) the same step with
    the plain versions of K4 and K5, held against (b); (d) the same step on
    the f32 K3 path, reported; (e) a default-settings solve to 1e-4, its
    residual on the cached operator; (f) three Adam steps;
 9. LOVE serving, the JAX benchmark's config 3d at N = 100,000, m = 1024
    query points: the cache (posterior_cache: one K3 launch per CG
    iteration of the alpha solve and per Lanczos step, 100 steps), cold and
    warm; the queries (posterior_from_cache: two K1 launches, no K3, no CG),
    warm, with points/s and the device's kernel time from a profiler trace;
    the uncached posterior at the same m, for the serving ratio; the LOVE
    variance's distance from the CG posterior's (reported); K3 at t = 1 and
    K1 at 1024 x 100,000 (t = 1 and t = 100, and with 8 query rows, its
    prepass), against their plain versions and timed beside their bounds;
    at N = 20,000 the fused cache and queries held against the plain path
    at the model's initial noise and at noise 1.0, with the plain path in
    f64 on the same start vector as witness, and the LOVE and CG posterior
    variances beside the exact one (f64, Cholesky; reported); the inverse
    root's backward at n = 3000 (eight K2 launches), fused twice, plain and
    f64 (reported);
10. the JAX benchmark's config 2, inv_quad_logdet and the root of 64 dense
    1024 x 1024 SPD matrices (no TPU kernel: PyTorch's dense products), timed
    and held against the same step in f64 on four of them, on the same
    probes and Lanczos start;
11. the JAX benchmark's config 1 at N = 1e7, rank 20: factorize, solve and
    inv_quad_logdet of the exact Woodbury operator, cold and warm (no kernel
    launch, no CG or SLQ), the solve's normwise backward error, iq and logdet
    against the same closed forms in f64, logdet beside N log(noise), the
    cap matrix's build beside one read of U, and the peak device memory;
12. the JAX benchmark's config 6 at N = 32,768: 16 CIQ draws
    (zero_mean_mvn_samples under ciq_samples), cold and warm, with the
    range estimate's CG and the MINRES iterations and K3's launches by width
    (t = 1 twenty times, t = 16 once per MINRES iteration and once more),
    held against the plain path on the same draws; the f64 plain path and,
    at n = 2048, |S S^T - K| / |K| as witnesses; K3 at t = 16 and t = 1
    timed beside its bound, and a profile of one draw; the backward of
    sum(sqrt_inv_matmul(K, z)^2) (two K2 calls of 240 columns, two
    launches each), held against the plain path at N = 8192;
13. the predictive distribution at config 3d's data (N = 1e5, m = 1024):
    posterior_distribution over the LOVE cache, then rsample of 16 draws and
    log_prob of them, with the solvers each ran and its launches; at N =
    20,000 the fused path held against the plain one on the same draws;
14. the JAX benchmark's config 4 at m = 180 (n = 32,400): sum(solve) +
    sum(inv_quad) + logdet of Kronecker(Toeplitz, Toeplitz) + 0.1 I through
    the closed forms, forward and backward (d/d ls) apart, cold and warm (no
    kernel launch; no CG, SLQ or Cholesky in the forward), its parts and a
    profile; solve, inv_quad and logdet held against a dense f64 Cholesky of
    the same matrix on the card, the port's f64 ls-gradient against the f64
    closed form (the f32 one reported);
15. the JAX benchmark's config 4b: SKI on n = 200,000 points on a 256 x 256
    grid, neg_mll under the bench's settings, forward and backward apart,
    cold and warm, with a profile; the port's gather and scatter-add and the
    JAX package's one-hot panels (W, W^T at t = 11 and t = 1, the whole
    mat-vec) timed and held against each other, the port's the faster; the
    Toeplitz mat-vec on both
    routes at n = 256 and 8192, the FFT route held against a dense f64
    product; neg_mll and its backward under the default settings (pivoted
    rank 15) under a peak-memory bound; posterior_mean and the LOVE
    posterior at m = 1024; no kernel launch; at n = 20,000 on a 64 x 64 grid,
    neg_mll and its gradient against the port in f64 on the same probes,
    inv_quad and the posterior mean against a dense f64 Cholesky, and at the
    bench's CG tolerance f32 and two f64 runs (summation order changed,
    entries rounded to f32) against f64, reported;
16. indexing, the fantasy update and the shipped harness: (a) at N = 100,000
    K[idx] (1024 random rows) stays a kernel operator whose mat-vecs at
    t = 1 and 11 launch K1, K[:50000, :50000] a symmetric one whose mat-vec
    launches K3, each held against its kernel's plain version, K[idx, idx]
    and K[idx, perm(idx)] against the dense values, under a bound on the
    phase's device memory; (b) the fantasy update (K + s2 I).cat_rows(B, C)
    with 64 new points, solved by CG for [y; y_new] unpreconditioned and
    under beta_features.default_preconditioner (iterations, time, K3
    launches, residual), the same two solves at n = 4096 held against an
    f64 Cholesky solve, and add_low_rank and cat_rows on a carried root
    against the dense result; (c) the port's LinearOperatorTestCase on the
    card (device="cuda") for a fused RBF kernel operator in f32 at n = 512
    (K1, K2 and K3 must launch), a CatLinearOperator and a
    MulLinearOperator;
17. the rest of the kernel operator (phase_kernel_family): (a) Matern-5/2,
    3/2, 1/2 and RQ at config 3's data (N = 100,000, per-dimension
    lengthscale) through inv_quad_logdet and its backward on the fused
    kernels, every launch under the covariance's id (K3 once per CG
    iteration, two K2 and one K3 in the backward, K1 in the predictive
    mean), held against the plain path (Matern-5/2 at N, the others at
    N_FAMILY_HELD), and K3, K2 and K1 of each timed beside RBF's; (b) the
    periodic and spectral mixture kernels on a 1-D series and the LMC
    multi-output operator on the blocked engine, no kernel launch, held
    against f64; (c) a covariance registered at run time with CUDA bodies,
    compiled into builds of K1-K4 of its own and launched under its id;
18. the inducing-point, classification, multitask and deep-kernel models at
    full width: (a) SGPR at N = 1,000,000, m = 512 (phase_sgpr): neg_elbo
    and its backward through the exact Woodbury forms, three Adam steps, the
    posterior at 1024 points, no kernel, CG or Lanczos; f32 against f64 at
    n = 100,000; (b) SVGP at N = 1,000,000, m = 1024, minibatches of 1024
    (phase_svgp): 50 timed steps, the full-data predictive, the posterior
    distribution and its log_prob; f32 against f64 on one minibatch; (c) the
    probit and logit classifiers and Poisson regression at (b)'s sizes
    (phase_classification); (d) the multitask GP at n = 10,000, T = 4
    (phase_multitask): the Kronecker closed forms, eigh's share of the step,
    the posteriors, held against f64 at n = 2000; (e) DKL at N = 100,000,
    d_in = 8, hidden (1000, 1000, 500, 50, 2) (phase_dkl): the training step
    (K3 once per CG iteration, the backward's two K2 launches carrying the
    gradient into the MLP), held against the plain path on the same probes
    (the loss, and the first layer's gradient at a noise where f32 solves
    are accurate), three Adam steps, the posterior (K1), the LOVE cache (K3 at t = 1) and
    queries (two K1 launches); the launches join the kernels line;
 7. one JSON line listing every ported kernel with its launches (K3's and
    K1's including phases 12, 13 and 18e), error, times and bound (bound_basis:
    the f32 rate for K4, the tensor cores' for K1, K2, K3 and K5; K5's t = 1
    time as ms_t1, the write-only pass beside K4 as write_only_ms; K3 at
    t = 1 as ms_t1, at config 6's shapes as ms_ciq_t16 and ms_ciq_t1, and K1
    at the LOVE shapes as ms_love_t1 and ms_love_t100, each with its plain
    time, bound and error; K1, K2 and K3 of each covariance as ms_by_covar,
    K3 at t = 1 as ms_t1_by_covar), then, as the last line,
    {"ok": true, "device": {...}}.

Any failed check, or any exception, exits non-zero without the last line.
Without a CUDA device, or without the package beside it, it fails at once.

    python3 chip_smoke.py --only woodbury,kron_toeplitz,ski [--package DIR]

runs only the named module-level phases (woodbury, kron_toeplitz, ski,
indexing, fantasy, harness, kernel_family, sgpr, svgp, classification,
multitask, dkl) after the build, with the package taken from DIR
(another commit's checkout) when given: the same phases, one card, two
commits.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet): f32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
PEAK_BYTES_PER_S = 3.35e12

N, D, M_STAR, PROBES = 100_000, 3, 64, 10
KERNEL_RTOL = 1e-4  # |kernel - plain| <= KERNEL_RTOL * max|plain|, see check_kernel
# K1 and K3 against kernel_matvec_acc3_plain, which repeats their three bf16
# products: what is left is summation order and the tensor cores' truncating
# accumulation (~2e-6 of the largest entry); against full precision they lie
# ~1e-5 off (the dropped lo x lo product), inside KERNEL_RTOL
ACC3_RTOL = 1e-5
# Fused vs plain path (and card vs CPU) on the same probes.  Both are f32;
# their mat-vecs differ by ~1e-7 relative, which ~20 iterations of
# preconditioned CG carry into the MLL and the posterior (~1e-5 at n = 2500);
# a wrong kernel moves them by O(1).
PATH_RTOL = 1e-3
TILE = 1024  # the tile of rbf_fused_closure's cache
CACHE_NOISE = 1.0  # the noise of the tile-cache path, where bf16(K) + D stays positive definite
# LOVE serving (the JAX benchmark's config 3d): queries a batch, Lanczos
# steps, warm repetitions timed, the size at which the fused path is held
# against the plain one, and the size of the inverse root's backward
M_LOVE, LOVE_K, LOVE_REPS, N_LOVE_HELD, N_INV_ROOT = 1024, 100, 5, 20_000, 3000
# the batched dense step (config 2): matrices, their size, and how many are
# held against f64
B_DENSE, N_DENSE, DENSE_HELD = 64, 1024, 4
# config 1, woodbury_10m_solve_iqld (bench.py:189-213): points, rank, noise,
# warm steps
N_WOODBURY, RANK_WOODBURY, NOISE_WOODBURY, WOODBURY_REPS = 10_000_000, 20, 0.5, 5
# config 6, ciq_sampling_n32k (bench.py:309-334): points, draws; the size of
# the backward's hold against the plain path and of the S S^T witness
N_CIQ, CIQ_SAMPLES, N_CIQ_HELD, N_CIQ_GRAM = 32_768, 16, 8192, 2048
# the predictive distribution at config 3d's data: draws, and the size of
# its hold against the plain path (config 3d's own: N, M_LOVE)
PRED_SAMPLES = 16
# config 4, kron_toeplitz_32k_solve_logdet (bench.py:246-270): points a
# side (n = m^2), grid spacing, lengthscale, noise, warm steps
M_KRON, H_KRON, LS_KRON, NOISE_KRON, KRON_REPS = 180, 0.05, 0.3, 0.1, 5
# config 4b, ski_200k_mll (bench.py:278-298): points, grid side, warm calls;
# query points; the hold's points and grid side; the Toeplitz sizes timed
N_SKI, G_SKI, SKI_REPS, M_SKI, N_SKI_HELD, G_SKI_HELD = 200_000, 256, 3, 1024, 20_000, 64
TOEPLITZ_SIZES = (256, 8192)
# 16a: the rows K[idx] takes, and the phase's device-memory bound
M_INDEX, INDEX_PEAK_BYTES = 1024, 4 * 10**9
# 16b: the fantasy points appended, CG's tolerance and iteration cap at
# N = 1e5; the size of the hold against an f64 Cholesky solve and its CG
# tolerance; the size of the root route's hold
M_FANTASY, FANTASY_TOL, FANTASY_ITERS = 64, 1e-2, 400
N_FANTASY_HELD, FANTASY_HELD_TOL, N_FANTASY_ROOT = 4096, 1e-4, 1024
# 16c: the kernel operator of the harness on the card: points (a jittered
# cube grid of side 8 on [0, 1]^3), the jitter and the lengthscale (the
# condition number is 76, so that f32 solves meet the harness's tolerances),
# and the tolerances that K1-K3's three-pass bf16 products need beyond the
# harness's own
N_HARNESS, HARNESS_JITTER, HARNESS_LS = 512, 0.04, 0.06
# (the mat-vec carries the three-pass bf16 products' ~1e-5; the f32
# gradients, fused or dense, sit ~1e-2 from each other; the finite
# difference of sqrt_inv_matmul, at eps = 1e-5 over a forward whose bf16
# splits are not smooth, lies a few percent from the gradient and moves from
# run to run (3.1% and 4.9% in two runs on an H100).  The phase
# prints the largest error each key sees, as a share of its limit and of the
# harness's own; PERF.md puts the card's readings beside these limits)
# 17: the kernel family at config 3's data: the per-dimension lengthscale,
# outputscale and noise of 17a, the size at which each covariance is held
# against the plain path (the plain path at N = 1e5 with CG to 1e-4 took a
# minute for Matern-5/2); 17b's 1-D series (periodic and spectral
# mixture: 16,384^2 f32 entries are the 1 GiB materialize_threshold) with its
# mixture's components, and the LMC operator's points (two rows each); 17c's
# size
FAMILY_LS, FAMILY_OS, FAMILY_NOISE, N_FAMILY_HELD = (0.6, 0.7, 0.8), 0.693, 0.127, 20_000
N_SERIES, Q_MIXTURE, N_LMC, N_REGISTERED = 16_384, 4, 20_000, 4096
# 18, the models at full width: (a) SGPR's points, inducing points and the
# size of its f32-against-f64 hold; (b, c) SVGP's points, inducing points,
# minibatch and steps; (d) the multitask model's points, tasks, task rank and
# the size of its hold; (e) DKL's points, input dimension and MLP widths
# (Wilson et al. 2016's for data sets above 6000 points); the query points of
# every posterior, and the Adam steps of 18a and 18e
N_SGPR, M_SGPR, N_SGPR_HELD = 1_000_000, 512, 100_000
N_SVGP, M_SVGP, B_SVGP, SVGP_STEPS = 1_000_000, 1024, 1024, 50
N_MT, T_MT, RANK_MT, N_MT_HELD = 10_000, 4, 2, 2000
N_DKL, D_DKL, HIDDEN_DKL = 100_000, 8, (1000, 1000, 500, 50, 2)
M_QUERY, ADAM_STEPS = 1024, 3
# the f32-against-f64 holds of 18a-18c.  f32's Cholesky of K_mm (m = 512) or
# K_zz (m = 1024) in a dense cloud takes psd_safe_cholesky's jitter where
# f64's does not, as in the JAX package; SGPR's trace term is a difference of
# sums of 1e5 entries, and SVGP's z and lengthscale gradients come through
# that factor.  SGPR: the loss in nats a point and the gradient as a share of
# its norm.  SVGP and its siblings, at the trained parameters (at the prior q
# the predictive does not depend on z or the lengthscale), both dtypes at
# SVGP_HELD_JITTER, fixed here, where f32's factor needs no more (checked), so
# that both factor one matrix: the loss relative and the gradient as a share
# of its norm, about 4x the largest gaps of the four models on an H100
# (1.3e-4 and 9.7e-4); with TF32 products the gradient moves by 0.1-0.3, so
# the same f32 model with TF32 allowed must fail them.  Against f64 at the
# model's own jitter (another matrix) the gap is reported
SGPR_LOSS_ATOL, SGPR_GRAD_RTOL = 5e-3, 5e-2
SVGP_HELD_JITTER, SVGP_LOSS_RTOL, SVGP_GRAD_RTOL = 1e-4, 5e-4, 5e-3
# 18e: the noises at which the first layer's weight gradient of the MLL's
# inverse quadratic term is compared (the model's own first), with CG to
# DKL_HELD_CG_TOL (at most DKL_HELD_CG_MAX iterations).  At the model's
# noise K's condition is ~1e5 and the fused path's gradient lies ~1e-2 from
# f64 and from itself, the plain path's ~2e-4 (the kernels' three bf16
# products and K3's atomic sums, amplified by the condition); the gap falls
# with the noise to ~2e-5 at DKL_HELD_NOISE, where it and the whole loss's
# gradient are held, fused against plain, to DKL_GRAD_RTOL of its norm
DKL_NOISES, DKL_HELD_NOISE = (0.127, 1.0, 10.0, 100.0), 100.0
DKL_GRAD_RTOL, DKL_HELD_CG_TOL, DKL_HELD_CG_MAX = 1e-4, 1e-6, 400
HARNESS_KERNEL_TOLERANCES = {
    "matmul": {"rtol": 1e-4, "atol": 2e-4},
    "grad": {"rtol": 1e-3, "atol": 1e-3},
    "sqrt_inv_matmul_grad": {"rtol": 1e-1, "atol": 1e-2},
}


def fail(message: str) -> None:
    print(f"FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(message: str) -> None:
    print(message, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card: one warm-up call, then
    ``reps`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(torch, fn) -> float:
    """Milliseconds of one call on the card, between two CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the flops over the
    peak of their type (f32 by default) and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


class SolverLog(logging.Handler):
    """What the solvers log under verbose_linalg: linear_cg's iteration counts
    (``counts``), MINRES's (``minres``) and, in order, the solvers that
    ``settings.record_linalg`` names (``names``)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.counts: list[int] = []
        self.minres: list[int] = []
        self.names: list[str] = []

    def clear(self):
        for seen in (self.counts, self.minres, self.names):
            seen.clear()

    def emit(self, record):
        if record.msg.startswith("linear_cg finished"):
            self.counts.append(int(record.args[0]))
        elif record.msg.startswith("minres finished"):
            self.minres.append(int(record.args[0]))
        elif record.msg.startswith("Running"):
            self.names.append(record.args[0])


@contextlib.contextmanager
def recording(module, name, record):
    """``module.name`` replaced, inside the block, by a call that first hands
    its arguments to ``record``; the wrappers' launch counts are untouched."""
    real = getattr(module, name)

    def call(*args):
        record(*args)
        return real(*args)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, real)


def rel_fro(a, b) -> float:
    """|a - b|_F / |b|_F, in f64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def phase_woodbury(c) -> None:
    """11. Config 1: factorize, solve, inv_quad_logdet and their sum on the
    exact Woodbury operator at N = 1e7, rank 20: no kernel launch, no CG or
    SLQ; the solve's normwise backward error, iq and logdet against the same
    closed forms in f64, logdet beside N log(noise)."""
    torch, lo, settings = c.torch, c.lo, c.settings
    from linear_operator_tpu_torch.operators import DenseLinearOperator, LowRankRootLinearOperator
    from linear_operator_tpu_torch.operators.low_rank_root_added_diag import (
        _build_cap_chol,
        woodbury_solve_closure,
    )

    n, r = N_WOODBURY, RANK_WOODBURY
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=c.dev).manual_seed(40)
    U = torch.randn(n, r, device=c.dev, generator=g) / math.sqrt(n)
    noise = torch.full((n,), NOISE_WOODBURY, device=c.dev)
    y = torch.randn(n, 1, device=c.dev, generator=g)

    def step():
        op = LowRankRootLinearOperator(DenseLinearOperator(U)).add_diagonal(noise).factorize()
        x = lo.solve(op, y)
        iq, ld = lo.inv_quad_logdet(op, y, logdet=True)
        return x, iq, ld, float(torch.sum(x) + iq + ld)

    step_s = []
    for _ in range(1 + WOODBURY_REPS):
        c.reset_counts()
        c.log.clear()
        with settings.verbose_linalg(True), torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, iq, ld, total = step()
            step_s.append(time.perf_counter() - t0)
        if any(c.counts().values()) or c.log.names:
            fail(f"the Woodbury step launched {c.counts()} and ran {c.log.names}: it must run no kernel, CG or SLQ")
    warm = statistics.median(step_s[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    iq, ld = float(iq), float(ld)
    say(f"Woodbury (config 1) N={n} rank={r}: cold {step_s[0] * 1e3:.3f} ms, warm median {warm * 1e3:.3f} ms "
        f"(of {WOODBURY_REPS}: {', '.join(f'{s * 1e3:.3f}' for s in step_s[1:])}), {1.0 / warm:.3f} solves/s; "
        f"sum(x) + iq + logdet {total:.6f}; no kernel, CG or SLQ; peak device memory {peak:.3f} GiB "
        f"(U {4 * n * r / 2**30:.3f} GiB)")
    # the cap matrix's build, which forms one scaled n x r temporary, beside
    # its parts, the same build in row chunks whose scaled copies stay in the
    # L2 cache (2^18 rows, 21 MB), and one read of U
    dinv = 1.0 / noise
    v1 = torch.randn(n, 1, device=c.dev, generator=g)

    def cap_in_chunks(rows=1 << 18):
        cap = torch.eye(r, device=c.dev)
        for s0 in range(0, n, rows):
            u = U[s0 : s0 + rows]
            cap = cap + (dinv[s0 : s0 + rows, None] * u).mT @ u
        return torch.linalg.cholesky(cap)

    cap_ms = cuda_ms(torch, lambda: _build_cap_chol(U, dinv), 5)
    parts = {label: cuda_ms(torch, fn, 5) for label, fn in (
        ("the scaling D^-1 U", lambda: dinv[:, None] * U), ("U^T U alone", lambda: U.mT @ U),
        ("in row chunks", cap_in_chunks), ("one read of U (U^T v)", lambda: U.mT @ v1))}
    say(f"  cap build {cap_ms:.3f} ms (its scaled copy of U: {4 * n * r / 1e6:.0f} MB written and read); "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f"; the read bound {1e3 * 4 * n * r / PEAK_BYTES_PER_S:.3f} ms")
    # the witness: the same closed forms in f64 on the same data
    with torch.no_grad():
        U64, y64, x64 = U.double(), y.double(), x.double()
        closure, ld64 = woodbury_solve_closure(U64, noise.double())
        iq64 = float(torch.sum(closure(y64) * y64))
        ld64 = float(ld64)
        resid = U64 @ (U64.mT @ x64) + noise.double()[:, None] * x64 - y64
        a_norm = float(torch.linalg.eigvalsh(U64.mT @ U64)[-1]) + NOISE_WOODBURY
        eta = float(resid.norm() / (a_norm * x64.norm() + y64.norm()))
        plain_rel = float(resid.norm() / y64.norm())
    e_iq, e_ld = abs(iq - iq64) / abs(iq64), abs(ld - ld64) / abs(ld64)
    ref_ld = n * math.log(NOISE_WOODBURY)
    say(f"  normwise backward error |Ax - y| / (|A| |x| + |y|) {eta:.3e} (relative residual {plain_rel:.3e}); "
        f"iq {iq:.6f} (f64 {iq64:.6f}, rel {e_iq:.2e}), logdet {ld:.4f} (f64 {ld64:.4f}, rel {e_ld:.2e}), "
        f"N log({NOISE_WOODBURY}) = {ref_ld:.4f} (logdet - that {ld - ref_ld:.4f}, the cap matrix's); peak device memory with the "
        f"f64 witness {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not (math.isfinite(total) and eta <= 1e-6 and max(e_iq, e_ld) <= 1e-5):
        fail("the Woodbury step is not backward stable or disagrees with the f64 closed forms")
    # logdet - N log(noise) = log det(I + U^T U / noise), in [0, r log(1 + |U|_2^2 / noise)]
    if not 0.0 <= ld - ref_ld <= r * math.log1p((a_norm - NOISE_WOODBURY) / NOISE_WOODBURY) * (1 + 1e-3):
        fail("the Woodbury logdet is not N log(noise) plus the cap matrix's logdet")
    del U, U64, x64, y64, resid, closure
    torch.cuda.empty_cache()


def phase_ciq(c) -> None:
    """12. Config 6: 16 CIQ draws of N(0, K) at N = 32,768 through
    zero_mean_mvn_samples under the benchmark's settings: K3 at t = 1 for
    the 20 preconditioned-CG steps of the range estimate, at t = 16 once per
    MINRES iteration and once for the last product, nothing else; held
    against the plain path on the same draws; the f64 plain path and
    S S^T - K at n = 2048 as witnesses; K3 at t = 16 timed; the backward of
    sum(sqrt_inv_matmul(K, z)^2) (two K2 calls of 240 columns, two launches
    each) at N, and held against the plain path at N_CIQ_HELD."""
    torch, lo, settings, rbf = c.torch, c.lo, c.settings, c.rbf
    from linear_operator_tpu_torch.functions._sqrt_inv_matmul import _Quadrature, _SqrtInvMatmul

    n, s = N_CIQ, CIQ_SAMPLES
    torch.cuda.empty_cache()
    g = torch.Generator(device=c.dev).manual_seed(50)
    x = torch.randn(n, D, device=c.dev, generator=g)

    def ciq_settings():
        """bench.py's settings for config 6 (bench.py:324-326)."""
        stack = contextlib.ExitStack()
        for ctx in [settings.ciq_samples(True), settings.minres_tolerance(1e-3),
                    settings.num_contour_quadrature(15), settings.preconditioner_mode("auto"),
                    settings.verbose_linalg(True)]:
            stack.enter_context(ctx)
        return stack

    def draw(model, xx, seed=60):
        """16 draws from the model's training covariance: the samples,
        seconds, launches, K3's widths, CG and MINRES iterations."""
        widths = []
        c.reset_counts()
        c.log.clear()
        with ciq_settings(), torch.no_grad(), recording(rbf, "_launch_matvec_sym",
                                                        lambda a, w, spec: widths.append(w.shape[-1])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.train_operator(xx).zero_mean_mvn_samples(
                s, generator=torch.Generator(device=c.dev).manual_seed(seed))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, c.counts(), widths, list(c.log.counts), list(c.log.minres)

    fused = lo.ExactGPRegression(block_rows=8192)
    runs = [draw(fused, x) for _ in range(3)]
    samples, _, cnt, widths, cg_iters, minres_iters = runs[0]
    warm = statistics.median(r[1] for r in runs[1:])
    # MINRES runs twice: the nested quadrature's P^{1/2} on the Nystrom
    # operator (no kernel), then the main solve on K
    k_main = minres_iters[-1]
    say(f"CIQ sampling (config 6) N={n} d={D} draws={s}: cold {runs[0][1]:.3f} s, warm {', '.join(f'{r[1]:.3f}' for r in runs[1:])} "
        f"s, {s / warm:.1f} samples/s; range-estimate CG iterations {cg_iters}, MINRES iterations {minres_iters} "
        f"(P^(1/2), then K), launches {cnt}, K3 widths t=1 x {widths.count(1)}, t=16 x {widths.count(16)}")
    if samples.shape != (s, n) or not torch.isfinite(samples).all():
        fail(f"CIQ samples of shape {tuple(samples.shape)} or not finite")
    if cg_iters != [20] or len(minres_iters) != 2:
        fail("CIQ sampling ran other solves than the 20-step range estimate and two MINRES")
    if sorted(widths) != [1] * 20 + [16] * (k_main + 1) or cnt != dict(K1=0, K3=21 + k_main, K2=0, K4=0, K5=0):
        fail("CIQ sampling did not launch K3 at t = 1 twenty times and at t = 16 once per MINRES iteration "
             "and once more, and nothing else")
    for r in runs[1:]:
        if r[2] != cnt:
            fail(f"a warm CIQ draw made launches {r[2]}, the cold one {cnt}")
    c.launches["K3"] += cnt["K3"]

    # K3 at the path's shapes: t = 16 (MINRES) and t = 1 (the range estimate)
    ls = math.log(2.0) + 1e-6
    xs = (x / ls).contiguous()
    v16, v1 = torch.randn(n, 16, device=c.dev, generator=g), torch.randn(n, 1, device=c.dev, generator=g)
    k3 = {t: c.timed_matvec(f"K3 rbf n={n} d={D} t={t}", lambda v=v: rbf.kernel_matvec_sym(xs, v), (xs, xs, v),
                            n * (n + 1) / 2, 4 * t, 4 * (n * D + 2 * n * t), reps=20, plain_reps=2)
          for t, v in ((16, v16), (1, v1))}
    c.stats["K3"].update(ms_ciq_t16=k3[16]["ms"], plain_ms_ciq_t16=k3[16]["plain_ms"],
                         bound_ms_ciq_t16=k3[16]["bound_ms"], max_abs_err_ciq_t16=k3[16]["max_abs_err"],
                         ms_ciq_t1=k3[1]["ms"])
    k3_s = ((k_main + 1) * k3[16]["ms"] + 20 * k3[1]["ms"]) / 1e3
    nblk = -(-n // 128)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"  a warm draw's K3 launches: {k_main + 1} x {k3[16]['ms']:.3f} ms (t=16) + 20 x {k3[1]['ms']:.3f} ms "
        f"(t=1) = {k3_s:.3f} s, {100 * k3_s / warm:.1f}% of its warm time; K3's persistent wave at N={n} "
        f"shares {nblk * (nblk + 1) // 2} tile pairs (128 x 128) among the CTAs of {sms} SMs, "
        f"{nblk * (nblk + 1) // 2 / sms:.1f} per SM")
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, q_s, _, _, _, q_minres = draw(fused, x)
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        dev_ms = sum(by_name.values())
        k3_ms = sum(v for k, v in by_name.items() if "sym_matvec" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        say(f"  profiled draw: {q_s * 1e3:.3f} ms wall, device kernels {dev_ms:.3f} ms "
            f"({100 * dev_ms / (q_s * 1e3):.1f}%), K3 {k3_ms:.3f} ms, {len(kern)} device events "
            f"({len(kern) / sum(q_minres):.1f} per MINRES iteration, of {sum(q_minres)}); top: "
            + "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in top))
    except Exception as exc:  # CUPTI tracing may be unavailable; no check rests on it
        say(f"  draw kernel time by profiler: not measured ({type(exc).__name__}: {exc})")

    # the plain path on the card on the same draws, held
    plain = lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False)
    p_samples, p_s, _, _, p_cg, p_minres = draw(plain, x)
    rel = rel_fro(samples, p_samples)
    say(f"  plain path: {p_s:.3f} s, CG iterations {p_cg}, MINRES iterations {p_minres}; |fused - plain|_F / "
        f"|plain|_F {rel:.3e}")
    if not rel <= PATH_RTOL:
        fail("CIQ samples disagree with the plain path")
    # witnesses (reported): the plain path in f64 on the same base and start
    # vector (drawn as zero_mean_mvn_samples draws them: the base, then the
    # start), and at N_CIQ_GRAM, S S^T against K for S = sqrt_matmul_ciq(K, I)
    wg = torch.Generator(device=c.dev).manual_seed(60)
    base = torch.randn((n, s), device=c.dev, generator=wg)
    init = torch.randn((n,), device=c.dev, generator=wg)
    ref = lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False, dtype=torch.float64)
    with ciq_settings(), torch.no_grad():
        K64 = ref.train_operator(x.double())
        half = _SqrtInvMatmul.apply(K64, base.double(), _Quadrature(K64, init.double()), *K64._leaves())
        s64 = K64._matmul(half).movedim(-1, 0)
        xg = x[:N_CIQ_GRAM].double()
        Kg = ref.train_operator(xg)
        S = lo.functions.sqrt_matmul_ciq(Kg, torch.eye(N_CIQ_GRAM, dtype=torch.float64, device=c.dev),
                                         generator=torch.Generator(device=c.dev).manual_seed(61))
        dense = Kg.to_dense()
        gram = float((S @ S.mT - dense).norm() / dense.norm())
    say(f"  witnesses (reported): fused to f64 plain {rel_fro(samples, s64):.3e}, plain to f64 plain "
        f"{rel_fro(p_samples, s64):.3e}; at n={N_CIQ_GRAM} in f64, |S S^T - K|_F / |K|_F {gram:.3e} for "
        f"S = sqrt_matmul_ciq(K, I) (exact CIQ gives 0)")
    del K64, half, s64, Kg, S, dense, base, init, xs, v16, v1

    # the backward of sum(sqrt_inv_matmul(K, z)^2) in the three raw parameters
    raw = ("raw_lengthscale", "raw_outputscale", "raw_noise")

    def ciq_grad(model, xx, z):
        widths, weighted = [], []
        model.zero_grad(set_to_none=True)
        c.reset_counts()
        c.log.clear()
        with ciq_settings(), recording(rbf, "_launch_matvec_sym", lambda a, w, spec: widths.append(w.shape[-1])), \
                recording(rbf, "_weighted_dx", lambda x1, x2, gg, v, covar: weighted.append(gg.shape[-1])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lo.sqrt_inv_matmul(model.train_operator(xx), z,
                                     generator=torch.Generator(device=c.dev).manual_seed(62))
            loss = torch.sum(out**2)
            float(loss.detach())
            t1 = time.perf_counter()
            fwd = c.counts()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        bwd = {k: v - fwd[k] for k, v in c.counts().items()}
        grads = torch.stack([getattr(model, name).grad for name in raw]).double()
        return dict(grads=grads, fwd_s=t1 - t0, bwd_s=t2 - t1, fwd=fwd, bwd=bwd, widths=widths, weighted=weighted,
                    minres=list(c.log.minres))

    z = torch.randn(n, s, device=c.dev, generator=g)
    big = ciq_grad(fused, x, z)
    say(f"  backward of sum(sqrt_inv_matmul(K, z)^2) N={n} t={s}: forward {big['fwd_s']:.3f} s, backward "
        f"{big['bwd_s']:.3f} s; forward launches {big['fwd']}, backward launches {big['bwd']}, K2 calls of "
        f"{big['weighted']} columns, MINRES iterations {big['minres']}, widest K3 {max(big['widths'])}; "
        f"grad {big['grads'].tolist()}")
    if not torch.isfinite(big["grads"]).all() or big["weighted"] != [15 * s, 15 * s] or big["bwd"]["K2"] != 4:
        fail("the CIQ backward is not finite or did not make two K2 calls of 240 columns, two launches each")
    if max(big["widths"]) > 16:
        fail("a K3 launch on the CIQ path took more than 16 columns")
    c.launches["K2"] += big["bwd"]["K2"]
    c.launches["K1"] += big["fwd"]["K1"] + big["bwd"]["K1"]
    # held at N_CIQ_HELD against the plain path, the same start vector
    xh, zh = x[:N_CIQ_HELD], z[:N_CIQ_HELD]
    held = {label: ciq_grad(lo.ExactGPRegression(block_rows=8192, use_fused_kernels=use), xh, zh)
            for label, use in (("fused", True), ("plain", False))}
    rel = float((held["fused"]["grads"] - held["plain"]["grads"]).norm() / held["plain"]["grads"].norm())
    say(f"  backward N={N_CIQ_HELD}: fused {held['fused']['grads'].tolist()}, plain {held['plain']['grads'].tolist()}, "
        f"|fused - plain| {rel:.3e} of the norm (MINRES iterations {held['fused']['minres']} and "
        f"{held['plain']['minres']})")
    if not rel <= PATH_RTOL:
        fail("the CIQ backward disagrees with the plain path")
    del x, z, xh, zh, fused, plain, ref
    torch.cuda.empty_cache()


def phase_predictive(c) -> None:
    """13. The predictive distribution at config 3d's data (N = 1e5, m =
    1024): posterior_distribution over the LOVE cache (phase 9's settings),
    then rsample of 16 draws and log_prob of them under the default settings,
    with the routes they took and their launches; at N_LOVE_HELD, the fused
    path held against the plain one on the same draws."""
    torch, lo, settings = c.torch, c.lo, c.settings
    torch.cuda.empty_cache()
    lg = torch.Generator(device=c.dev).manual_seed(20)  # phase 9's data
    xl = torch.randn(N, D, device=c.dev, generator=lg)
    yl = torch.sin(3.0 * xl[:, 0]) + 0.1 * torch.randn(N, device=c.dev, generator=lg)
    xq = torch.randn(M_LOVE, D, device=c.dev, generator=lg)

    def predictive(model, xx, yy):
        """The distribution, then its draws and their log density: each step's
        seconds, launches, solvers and CG iterations."""
        steps = {}

        def run(label, fn, *ctxs):
            c.reset_counts()
            c.log.clear()
            with contextlib.ExitStack() as stack:
                for ctx in ctxs:
                    stack.enter_context(ctx)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                steps[label] = dict(s=time.perf_counter() - t0, launches=c.counts(), solvers=sorted(set(c.log.names)),
                                    cg=list(c.log.counts))
            return out

        dist = run("build", lambda: model.posterior_distribution(xx, yy, xq,
                                                                 generator=torch.Generator().manual_seed(2)),
                   c.love_settings())
        draws = run("rsample", lambda: dist.rsample((PRED_SAMPLES,),
                                                    generator=torch.Generator(device=c.dev).manual_seed(3)),
                    settings.verbose_linalg(True), torch.no_grad())
        lp = run("log_prob", lambda: dist.log_prob(draws, generator=torch.Generator(device=c.dev).manual_seed(4)),
                 settings.verbose_linalg(True), torch.no_grad())
        return dist, draws, lp, steps

    model = lo.ExactGPRegression(block_rows=8192)
    dist, draws, lp, steps = predictive(model, xl, yl)
    for label, st in steps.items():
        say(f"predictive N={N} m={M_LOVE}, {label}: {st['s']:.3f} s, solvers {st['solvers']}, CG iterations "
            f"{st['cg']}, launches {st['launches']}")
    if draws.shape != (PRED_SAMPLES, M_LOVE) or lp.shape != (PRED_SAMPLES,):
        fail(f"predictive draws {tuple(draws.shape)} or log_prob {tuple(lp.shape)}")
    if not (torch.isfinite(dist.mean).all() and torch.isfinite(draws).all() and torch.isfinite(lp).all()):
        fail("the predictive mean, draws or log densities are not finite")
    if steps["build"]["launches"]["K1"] != 2:
        fail("the predictive distribution's build did not make two K1 launches (K_s* alpha, K_s* R)")
    say(f"  log_prob of the draws: {', '.join(f'{v:.2f}' for v in lp.tolist()[:4])}, ...; "
        f"{PRED_SAMPLES / (steps['rsample']['s'] + steps['log_prob']['s']):.1f} draws with their densities a second")
    for st in steps.values():
        for key in ("K1", "K3"):
            c.launches[key] += st["launches"][key]
    del dist, draws, lp, model

    # at N_LOVE_HELD: fused against plain, one generator seed for each step.
    # At the model's initial parameters the predictive covariance (RBF at
    # lengthscale 0.69 over 1024 points in 3-d, plus 1e-6) is ill-conditioned:
    # the draws (a Lanczos root) and the log densities (CG to 1000
    # iterations) carry the kernels' ~1e-5 through it, so there the mean and
    # covariance are held and the draws and densities reported; at
    # lengthscale 0.1 the covariance is well-conditioned and all four are held
    xh, yh = xl[:N_LOVE_HELD], yl[:N_LOVE_HELD]
    for ls in (None, 0.1):
        tag = "the initial lengthscale 0.69" if ls is None else f"lengthscale {ls}"
        models = {label: lo.ExactGPRegression(block_rows=8192, use_fused_kernels=use)
                  for label, use in (("fused", True), ("plain", False))}
        if ls is not None:
            for m_ in models.values():
                with torch.no_grad():
                    m_.raw_lengthscale.fill_(math.log(math.expm1(ls - 1e-6)))
        runs = {label: predictive(m_, xh, yh) for label, m_ in models.items()}
        (fd, fdraws, _, fsteps), (pd, pdraws, plp, _) = runs["fused"], runs["plain"]
        with torch.no_grad():
            prior = float(models["plain"].covariance(xq).diagonal().max())
            d_mean = float((fd.mean - pd.mean).abs().max() / pd.mean.abs().max())
            d_cov = float((fd.covariance_matrix - pd.covariance_matrix).abs().max()) / prior
            d_draws = rel_fro(fdraws, pdraws)
            # the fused distribution's density at the plain path's draws
            flp_at = fd.log_prob(pdraws, generator=torch.Generator(device=c.dev).manual_seed(4))
            d_lp = float((flp_at - plp).abs().max() / plp.abs().max())
            evals = torch.linalg.eigvalsh(pd.covariance_matrix.double())
        say(f"  predictive N={N_LOVE_HELD} m={M_LOVE}, {tag}: covariance eigenvalues {float(evals[0]):.3e} .. "
            f"{float(evals[-1]):.3e}; rsample's solvers {fsteps['rsample']['solvers']}, log_prob's CG iterations "
            f"{fsteps['log_prob']['cg']}; fused to plain: mean {d_mean:.3e} of max|mean|, covariance {d_cov:.3e} of "
            f"the prior variance, draws {d_draws:.3e} (relative Frobenius), log_prob at the same points {d_lp:.3e}"
            + (" (the last two reported)" if ls is None else ""))
        held = (d_mean, d_cov) if ls is None else (d_mean, d_cov, d_draws, d_lp)
        if not max(held) <= PATH_RTOL:
            fail(f"the predictive distribution disagrees with the plain path at N={N_LOVE_HELD}, {tag}")
    del runs, xl, yl, xq, xh, yh
    torch.cuda.empty_cache()


def profiled(torch, label, fn) -> None:
    """One call of ``fn`` under the profiler: its wall time, the device
    kernels' summed time as a share of it, and the top kernels by time.
    Reported only (CUPTI tracing may be unavailable; no check rests on it)."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        dev_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        say(f"  profiled {label}: {wall_ms:.3f} ms wall, device kernels {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}% busy), {len(kern)} device events; top: "
            + "; ".join(f"{name[:50]} {ms:.3f} ms" for name, ms in top))
    except Exception as exc:
        say(f"  profiled {label}: not measured ({type(exc).__name__}: {exc})")


def _no_tf32(c) -> None:
    if c.torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: every f32 product of the structured paths must run in full f32")


def _kron_toeplitz(c, ls, dtype):
    """Config 4's operator: Kronecker(Toeplitz(col(ls)), Toeplitz(col(1.3 ls))) + 0.1 I."""
    lo = c.lo
    from linear_operator_tpu_torch.models.ski import rbf_toeplitz_column

    cols = [rbf_toeplitz_column(M_KRON, H_KRON, scale * ls, dtype=dtype) for scale in (1.0, 1.3)]
    kron = lo.KroneckerProductLinearOperator(tuple(lo.ToeplitzLinearOperator(col) for col in cols))
    return kron.add_diagonal(c.torch.tensor(NOISE_KRON, dtype=dtype, device=c.dev))


def _kron_closed_form(torch, m, ls, y):
    """Config 4's step value and d/d(ls) in f64 from the factors'
    eigendecompositions, dK/d(ls) written out (independent of autograd and
    of the operators): d total = -(w + x)^T K' x + tr(K^-1 K'), with
    w = K^-1 1, x = K^-1 y, K' = T1' (x) T2 + T1 (x) T2'."""
    i = torch.arange(m, dtype=torch.float64, device=y.device)
    d2 = ((i[:, None] - i[None, :]) * H_KRON) ** 2
    t1, t2 = torch.exp(-0.5 * d2 / ls**2), torch.exp(-0.5 * d2 / (1.3 * ls) ** 2)
    dt1, dt2 = t1 * d2 / ls**3, t2 * d2 / (1.3**2 * ls**3)
    a, q1 = torch.linalg.eigh(t1)
    b, q2 = torch.linalg.eigh(t2)
    shifted = torch.kron(a, b) + NOISE_KRON

    def kron_mv(left, right, v):
        return (left @ v.reshape(m, m) @ right.T).reshape(-1)

    def solve(v):
        return kron_mv(q1, q2, kron_mv(q1.T, q2.T, v) / shifted)

    yv = y[:, 0].double()
    x, w = solve(yv), solve(torch.ones_like(yv))
    kx = kron_mv(dt1, t2, x) + kron_mv(t1, dt2, x)
    trace = torch.sum(torch.kron(torch.diag(q1.T @ dt1 @ q1), b) / shifted) + torch.sum(
        torch.kron(a, torch.diag(q2.T @ dt2 @ q2)) / shifted)
    total = x.sum() + x @ yv + torch.sum(torch.log(shifted))
    return float(total), float(-(w + x) @ kx + trace)


def phase_kron_toeplitz(c) -> None:
    """14. Config 4 at m = 180 (n = 32,400): sum(solve(op, y)) + sum(iq) +
    sum(ld) of Kronecker(Toeplitz, Toeplitz) + 0.1 I through the closed forms
    (two 180 x 180 eigendecompositions; no CG, no SLQ, no Cholesky of the
    whole matrix, no kernel launch), cold and warm, forward and backward
    (d/d(ls)) apart; solve, iq and logdet held against a dense f64 Cholesky
    of the same matrix on the card, the ls-gradient of the port in f64 held
    against the f64 closed form (the f32 one reported)."""
    torch, lo, settings = c.torch, c.lo, c.settings
    _no_tf32(c)
    m = M_KRON
    n = m * m
    torch.cuda.empty_cache()
    g = torch.Generator(device=c.dev).manual_seed(70)
    y = torch.randn(n, 1, device=c.dev, generator=g)

    def step(ls, yy):
        op = _kron_toeplitz(c, ls, yy.dtype)
        x = lo.solve(op, yy)
        iq, ld = lo.inv_quad_logdet(op, yy, logdet=True)
        return op, x, iq, ld, x.sum() + iq.sum() + ld.sum()

    fwd_s, bwd_s, bwd_cg = [], [], []
    for rep in range(1 + KRON_REPS):
        c.reset_counts()
        c.log.clear()
        ls = torch.tensor(LS_KRON, device=c.dev, requires_grad=True)
        with settings.verbose_linalg(True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op, x, iq, ld, total = step(ls, y)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
            fwd_names = list(c.log.names)
            c.log.clear()
            t0 = time.perf_counter()
            total.backward()
            torch.cuda.synchronize()
            bwd_s.append(time.perf_counter() - t0)
            bwd_cg.append(list(c.log.counts))
        if any(c.counts().values()):
            fail(f"config 4 launched {c.counts()}: it runs no kernel")
        if fwd_names:
            fail(f"config 4's forward ran {fwd_names}: the closed forms run no CG, SLQ or Cholesky")
    if type(op).__name__ != "KroneckerProductAddedDiagLinearOperator":
        fail(f"kron.add_diagonal gave a {type(op).__name__}")
    f32_grad = float(ls.grad)
    warm_f, warm_b = statistics.median(fwd_s[1:]), statistics.median(bwd_s[1:])
    say(f"Kronecker-Toeplitz (config 4) m={m} n={n}: forward cold {fwd_s[0] * 1e3:.3f} ms, warm median "
        f"{warm_f * 1e3:.3f} ms (of {KRON_REPS}: {', '.join(f'{t * 1e3:.3f}' for t in fwd_s[1:])}), "
        f"{1.0 / warm_f:.2f} steps/s; backward (d/d ls) cold {bwd_s[0] * 1e3:.3f} ms, warm median "
        f"{warm_b * 1e3:.3f} ms, its CG iterations {bwd_cg[-1]} (the solve's backward solves with op.mT, an "
        f"unstructured sum, as the JAX package does); no kernel, no CG, SLQ or Cholesky in the forward; "
        f"total {float(total.detach()):.6f}")
    # the forward's parts, warm: the batched eigendecomposition of the two
    # factors, and one Kronecker sweep of the eigenvectors
    with torch.no_grad():
        kron = op.operators[0]
        evals, evecs = kron.eigh()
        parts = {"eigh of the factors": cuda_ms(torch, lambda: kron.eigh(), 5),
                 "one sweep Q^T y": cuda_ms(torch, lambda: evecs._t_matmul(y), 20),
                 f"a Toeplitz factor's dense product ({m} x {m} by {m} columns)":
                     cuda_ms(torch, lambda: kron.operators[0]._matmul(y.reshape(m, m)), 20)}
    say("  parts: " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()))
    # a backward-stable f32 solve lies up to cond(K) u from the exact one
    cond = float((evals.max() + NOISE_KRON) / (evals.min() + NOISE_KRON))
    solve_rtol = max(1e-4, cond * 2.0**-24)

    def fwd_bwd():
        ls_p = torch.tensor(LS_KRON, device=c.dev, requires_grad=True)
        step(ls_p, y)[-1].backward()

    profiled(torch, "warm step (forward and backward)", fwd_bwd)

    # held: solve, iq and logdet against a dense f64 Cholesky of the same
    # matrix (8.4 GB) on the card
    with torch.no_grad():
        op64 = _kron_toeplitz(c, torch.tensor(LS_KRON, dtype=torch.float64, device=c.dev), torch.float64)
        t0 = time.perf_counter()
        k64 = op64.operators[0].to_dense()
        k64.diagonal().add_(NOISE_KRON)
        chol, info = torch.linalg.cholesky_ex(k64)
        del k64
        y64 = y.double()
        x64 = torch.cholesky_solve(y64, chol)
        iq64 = float(torch.sum(x64 * y64))
        ld64 = float(2.0 * torch.log(torch.diagonal(chol)).sum())
        torch.cuda.synchronize()
        chol_s = time.perf_counter() - t0
        del chol
        peak = torch.cuda.max_memory_allocated() / 2**30
    e_x = float((x.detach().double() - x64).abs().max() / x64.abs().max())
    e_iq, e_ld = abs(float(iq.detach()) - iq64) / abs(iq64), abs(float(ld.detach()) - ld64) / abs(ld64)
    say(f"  against a dense f64 Cholesky ({chol_s:.3f} s, info {int(info)}, peak device memory {peak:.2f} GiB): "
        f"solve {e_x:.3e} of max|x| (held to cond(K) u = {cond:.1f} x 2^-24 = {solve_rtol:.2e}), iq {e_iq:.3e}, "
        f"logdet {e_ld:.3e} (held to 1e-4)")
    if int(info) != 0 or not (e_x <= solve_rtol and max(e_iq, e_ld) <= 1e-4):
        fail("config 4's closed forms disagree with a dense f64 Cholesky")

    # held: the port's ls-gradient in f64 on the card (its solve's backward
    # CG run to 1e-10) against the f64 closed form; the f32 one reported
    want_total, want_grad = _kron_closed_form(torch, m, LS_KRON, y)
    ls64 = torch.tensor(LS_KRON, dtype=torch.float64, device=c.dev, requires_grad=True)
    *_, total64 = step(ls64, y.double())
    c.log.clear()
    with settings.cg_tolerance(1e-10), settings.verbose_linalg(True):
        total64.backward()
    e64 = abs(float(ls64.grad) - want_grad) / abs(want_grad)
    ls32 = torch.tensor(LS_KRON, device=c.dev, requires_grad=True)
    *_, total32 = step(ls32, y)
    with settings.cg_tolerance(1e-5):
        total32.backward()
    say(f"  d total / d ls: f64 closed form {want_grad:.6f} (total {want_total:.6f}); the port in f64 "
        f"{float(ls64.grad):.6f} ({e64:.2e}, backward CG {c.log.counts}; held to 1e-5); in f32 at the default "
        f"settings {f32_grad:.4f} ({abs(f32_grad - want_grad) / abs(want_grad):.2e}), with CG to 1e-5 "
        f"{float(ls32.grad):.4f} ({abs(float(ls32.grad) - want_grad) / abs(want_grad):.2e}): reported, not held "
        f"(inv_quad's gradient through the f32 eigenvectors of numerically low-rank factors, shared with the JAX "
        f"package)")
    if not (e64 <= 1e-5 and abs(float(total64.detach()) - want_total) <= 1e-8 * abs(want_total)):
        fail("config 4's f64 ls-gradient or value disagrees with the closed form")
    del op64, x64, y64, op, x
    torch.cuda.empty_cache()


def _onehot_panel(torch, idx, w, m):
    """(B, k) indices and weights -> the dense (B, m) one-hot interpolation panel."""
    oh = (idx[..., None] == torch.arange(m, dtype=idx.dtype, device=idx.device)).to(w.dtype)
    return torch.sum(oh * w[..., None], dim=-2)


def _onehot_block(n, m1, t):
    """The JAX package's block rule: 8 Mi panel elements (block * m1 * t),
    256 to 16384 rows in steps of 256."""
    block = max(256, min(16384, 8 * 1024 * 1024 // (m1 * t)))
    return min((block // 256) * 256, max(256, -(-n // 256) * 256))


def onehot_wt(torch, idx, val, rhs, sizes):
    """W^T rhs by the JAX package's one-hot panels (linear_operator_tpu/utils/
    grid_interp.py ``grid_t_matmul``) on a two-dimensional grid: the second
    dimension expanded into the columns, the first contracted by a dense
    product.  The TPU design, timed here beside the port's gather and
    scatter-add; the port does not use it."""
    (m0, m1), (n, t) = sizes, rhs.shape
    block = _onehot_block(n, m1, t)
    acc = torch.zeros((m0, m1 * t), dtype=rhs.dtype, device=rhs.device)
    for start in range(0, n, block):
        rows = slice(start, start + block)
        w1 = _onehot_panel(torch, idx[1][rows], val[1][rows], m1)
        q = (w1[:, :, None] * rhs[rows, None, :]).reshape(w1.shape[0], -1)
        acc = acc + _onehot_panel(torch, idx[0][rows], val[0][rows], m0).mT @ q
    return acc.reshape(m0 * m1, t)


def onehot_w(torch, idx, val, grid_vec, sizes):
    """W grid_vec by the one-hot panels (``grid_matmul``), as ``onehot_wt``."""
    (m0, m1), t, n = sizes, grid_vec.shape[-1], idx[0].shape[0]
    block = _onehot_block(n, m1, t)
    g = grid_vec.reshape(m0, m1 * t)
    outs = []
    for start in range(0, n, block):
        rows = slice(start, start + block)
        c = _onehot_panel(torch, idx[0][rows], val[0][rows], m0) @ g
        w1 = _onehot_panel(torch, idx[1][rows], val[1][rows], m1)
        outs.append(torch.sum(c.reshape(-1, m1, t) * w1[:, :, None], dim=1))
    return torch.cat(outs)


def phase_ski(c) -> None:
    """15. Config 4b: KISS-GP on n = 200,000 points on a 256 x 256 grid
    (linear stencils, the model's initial parameters): neg_mll under the
    bench's settings, forward and backward, cold and warm; the port's gather
    and scatter-add timed beside the JAX package's one-hot panels (W, W^T at
    t = 11 and 1, the whole mat-vec) and held against them; the Toeplitz routes timed at 256 and 8192,
    the FFT route held against a dense f64 product; neg_mll under the
    default settings (pivoted rank 15) with the peak device memory;
    posterior_mean and the LOVE posterior at m = 1024; no kernel launch.  At
    n = 20,000 on a 64 x 64 grid: neg_mll and its gradient against the port
    in f64 on the same probes, inv_quad and the posterior mean against a
    dense f64 Cholesky, the LOVE variance reported; at the bench's CG
    tolerance, f32 against f64 beside two f64 runs that differ from the first
    only in summation order or in the operator's entries rounded to f32."""
    torch, lo, settings = c.torch, c.lo, c.settings
    from linear_operator_tpu_torch.functions import _inv_quad_logdet as iqld
    from linear_operator_tpu_torch.utils import sparse

    _no_tf32(c)
    torch.cuda.empty_cache()
    g = torch.Generator(device=c.dev).manual_seed(80)

    def data(n):
        xx = torch.rand(n, 2, device=c.dev, generator=g)
        return xx, torch.sin(6.0 * xx[:, 0]) * torch.cos(4.0 * xx[:, 1])

    def bench():
        """bench.py's settings for config 4b (bench.py:286-289)."""
        stack = contextlib.ExitStack()
        for ctx in [settings.max_cholesky_size(0), settings.num_trace_samples(10), settings.max_cg_iterations(100),
                    settings.cg_tolerance(1.0), settings.min_preconditioning_size(10**9),
                    settings.max_lanczos_quadrature_iterations(20), settings.verbose_linalg(True)]:
            stack.enter_context(ctx)
        return stack

    x, y = data(N_SKI)
    xq = torch.rand(M_SKI, 2, device=c.dev, generator=g)
    model = lo.SKIGPRegression(lo.make_grid(x, (G_SKI, G_SKI)))
    c.reset_counts()

    def timed(fn, *ctxs):
        c.log.clear()
        with contextlib.ExitStack() as stack:
            for ctx in ctxs:
                stack.enter_context(ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, list(c.log.counts)

    fwd = [timed(lambda: float(model.neg_mll(x, y, generator=torch.Generator(device=c.dev).manual_seed(1))),
                 bench(), torch.no_grad()) for _ in range(1 + SKI_REPS)]
    steps = []
    for _ in range(SKI_REPS):
        model.zero_grad()
        loss, f_s, f_cg = timed(lambda: model.neg_mll(x, y, generator=torch.Generator(device=c.dev).manual_seed(1)),
                                bench())
        _, b_s, _ = timed(loss.backward, bench())
        steps.append((f_s, b_s, f_cg))
    grads = [float(p.grad.norm()) for p in (model.raw_lengthscale, model.raw_outputscale, model.raw_noise)]
    warm = statistics.median(r[1] for r in fwd[1:])
    say(f"SKI (config 4b) n={N_SKI} grid {G_SKI}x{G_SKI} linear: neg_mll {fwd[0][0]:.6f}, forward cold "
        f"{fwd[0][1]:.3f} s, warm median {warm:.4f} s (of {SKI_REPS}: {', '.join(f'{r[1]:.4f}' for r in fwd[1:])}), "
        f"{1.0 / warm:.2f} solves/s, CG iterations {fwd[-1][2]}; with the gradient: forward "
        f"{statistics.median(s[0] for s in steps):.4f} s, backward {statistics.median(s[1] for s in steps):.4f} s "
        f"(each of {SKI_REPS}: {', '.join(f'{s[0]:.4f}/{s[1]:.4f}' for s in steps)}); gradient norms {grads}")
    if not (math.isfinite(fwd[0][0]) and all(math.isfinite(v) and v > 0 for v in grads)):
        fail("SKI's neg_mll or its gradient is not finite")

    def ski_step():
        with bench():
            model.neg_mll(x, y, generator=torch.Generator(device=c.dev).manual_seed(1)).backward()

    profiled(torch, "warm neg_mll with its backward", ski_step)

    # the port's gather and scatter-add against the JAX package's one-hot
    # panels at config 4b's shapes
    with torch.no_grad():
        op = model.covariance(x)
        li, lv = model._interp_weights_per_dim(x)
        fi, fv = op.left_indices, op.left_values
        sizes, mgrid = (G_SKI, G_SKI), G_SKI * G_SKI
        routes = {}
        for t in (11, 1):
            v_pts = torch.randn(N_SKI, t, device=c.dev, generator=g)
            v_grid = torch.randn(mgrid, t, device=c.dev, generator=g)
            pairs = {
                "W^T": (lambda: onehot_wt(torch, li, lv, v_pts, sizes),
                        lambda: sparse.left_t_interp(fi, fv, v_pts, mgrid)),
                "W": (lambda: onehot_w(torch, li, lv, v_grid, sizes),
                      lambda: sparse.left_interp(fi, fv, v_grid)),
                "W K W^T": (lambda: onehot_w(torch, li, lv, op.base._matmul(onehot_wt(torch, li, lv, v_pts, sizes)), sizes),
                            lambda: op._matmul(v_pts)),
            }
            for name, (onehot, flat_fn) in pairs.items():
                a, b = onehot(), flat_fn()
                err = float((a - b).abs().max() / b.abs().max())
                routes[(name, t)] = (cuda_ms(torch, onehot, 3), cuda_ms(torch, flat_fn, 20), err)
        k_ms = cuda_ms(torch, lambda: op.base._matmul(torch.randn(mgrid, 11, device=c.dev, generator=g)), 20)
    say("  interpolation routes (one-hot / flat ms, |one-hot - flat| / max|flat|): " + "; ".join(
        f"{name} t={t}: {a:.3f} / {b:.3f} ({a / b:.1f}x), {e:.1e}" for (name, t), (a, b, e) in routes.items())
        + f"; the grid operator's Kronecker mat-vec alone (t=11) {k_ms:.3f} ms; the port's route: flat")
    if max(e for _, _, e in routes.values()) > 1e-5:
        fail("the one-hot and flat interpolation routes disagree at n = 200,000")
    if not all(routes[(name, t)][1] < routes[(name, t)][0] for name in ("W", "W^T", "W K W^T") for t in (11, 1)):
        fail("the port's flat route is not the faster one on the card")

    # the Toeplitz routes, and the FFT route against a dense f64 product
    from linear_operator_tpu_torch.models.ski import rbf_toeplitz_column

    tz = {}
    for m in TOEPLITZ_SIZES:
        col = rbf_toeplitz_column(m, 1.0 / (m - 1), torch.tensor(0.1, device=c.dev))
        top = lo.ToeplitzLinearOperator(col)
        v = torch.randn(m, 11, device=c.dev, generator=g)
        with torch.no_grad():
            with settings.toeplitz_fft_min_size(10**9):
                dense_ms = cuda_ms(torch, lambda: top._matmul(v), 20)
                dense_out = top._matmul(v)
            with settings.toeplitz_fft_min_size(0):
                fft_ms = cuda_ms(torch, lambda: top._matmul(v), 20)
                fft_out = top._matmul(v)
            exact = lo.ToeplitzLinearOperator(col.double()).to_dense() @ v.double()
        tz[m] = (dense_ms, fft_ms, float((fft_out.double() - exact).abs().max() / exact.abs().max()),
                 float((dense_out.double() - exact).abs().max() / exact.abs().max()))
    say("  Toeplitz mat-vec, t=11 (dense / FFT ms; FFT and dense against f64): " + "; ".join(
        f"n={m}: {d:.4f} / {f:.4f}, {ef:.1e}, {ed:.1e}" for m, (d, f, ef, ed) in tz.items())
        + f"; the default route switches at toeplitz_fft_min_size = {settings.toeplitz_fft_min_size.value()}")
    if not tz[TOEPLITZ_SIZES[-1]][2] <= 1e-5:
        fail(f"the Toeplitz FFT route disagrees with the dense f64 product at n = {TOEPLITZ_SIZES[-1]}")

    # the default settings (pivoted rank 15): the training step's peak memory
    model.zero_grad()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated() / 2**30
    loss, d_s, d_cg = timed(lambda: model.neg_mll(x, y, generator=torch.Generator(device=c.dev).manual_seed(2)),
                            settings.verbose_linalg(True))
    pivoted = "pivoted_cholesky" in c.log.names
    _, db_s, _ = timed(loss.backward)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  default settings (pivoted rank 15): neg_mll {float(loss.detach()):.6f} in {d_s:.3f} s, backward {db_s:.3f} s, "
        f"CG iterations {d_cg}, pivoted Cholesky {'ran' if pivoted else 'DID NOT RUN'}; peak device memory "
        f"{peak:.3f} GiB ({base_mem:.3f} before; a dense f64 200k^2 matrix would take 320 GB)")
    if not (pivoted and math.isfinite(float(loss.detach())) and peak <= 2.0):
        fail("SKI under the default settings did not run the pivoted preconditioner or densified")

    # posterior_mean and the LOVE posterior at m = 1024
    post = []
    for _ in range(1 + SKI_REPS):
        mean, mean_s, mean_cg = timed(lambda: model.posterior_mean(x, y, xq), bench(), torch.no_grad())
        (lmean, lvar), love_s, love_cg = timed(
            lambda: model.posterior(x, y, xq, generator=torch.Generator(device=c.dev).manual_seed(3)),
            bench(), torch.no_grad())
        post.append((mean_s, love_s))
    say(f"  posterior_mean m={M_SKI}: warm median {statistics.median(p[0] for p in post[1:]) * 1e3:.2f} ms "
        f"(cold {post[0][0] * 1e3:.2f}), CG {mean_cg}; LOVE posterior: warm median "
        f"{statistics.median(p[1] for p in post[1:]) * 1e3:.2f} ms (cold {post[0][1] * 1e3:.2f}), CG {love_cg}")
    if not all(bool(torch.isfinite(t).all()) for t in (mean, lmean, lvar)) or mean.shape != (M_SKI,):
        fail("the SKI posterior is not finite or of the wrong shape")
    if any(c.counts().values()):
        fail(f"config 4b launched {c.counts()}: it runs no kernel")
    del op, model, x, y, loss
    torch.cuda.empty_cache()

    # the hold at n = 20,000 on a 64 x 64 grid
    xh, yh = data(N_SKI_HELD)
    xqh = torch.rand(M_SKI, 2, device=c.dev, generator=g)
    probes = torch.randn(N_SKI_HELD, 10, device=c.dev, generator=g, dtype=torch.float64)
    grid = lo.make_grid(xh, (G_SKI_HELD, G_SKI_HELD))
    real_randn = iqld.randn
    results, at_bench_tol = {}, {}
    drawn = {"probes": probes}

    class RoundedSKI(lo.SKIGPRegression):
        """The model in f64 on the f32 model's operator entries: stencil
        weights and Toeplitz columns rounded to f32."""

        def _interp_weights_per_dim(self, xx):
            idx, w = super()._interp_weights_per_dim(xx)
            return idx, tuple(v.float().double() for v in w)

        def grid_operator(self):
            return lo.KroneckerProductLinearOperator(tuple(
                lo.ToeplitzLinearOperator(f.column.float().double()) for f in super().grid_operator().operators))

    def mll_and_grad(mdl, dtype, order=None):
        """neg_mll and its gradient; ``order`` permutes the points and their
        probe rows, which leaves the value exact and changes the summation order."""
        mdl.zero_grad()
        xx, yy, drawn["probes"] = (xh, yh, probes) if order is None else (xh[order], yh[order], probes[order])
        loss = mdl.neg_mll(xx.to(dtype), yy.to(dtype), generator=torch.Generator(device=c.dev))
        loss.backward()
        return float(loss.detach()), torch.cat([p.grad.reshape(-1) for p in (
            mdl.raw_lengthscale, mdl.raw_outputscale, mdl.raw_noise)]).double(), list(c.log.counts)

    try:
        # the same probes for both dtypes (the model draws them through randn)
        iqld.randn = lambda shape, dtype, device, generator: drawn["probes"].to(dtype)
        for dtype in (torch.float32, torch.float64):
            mdl = lo.SKIGPRegression(grid, dtype=dtype)
            # held with CG to 1e-4: at the bench's tolerance (1.0) CG runs the
            # 20 iterations SLQ's tridiagonal matrices take, where on this
            # numerically low-rank operator (a lengthscale of 36 grid steps)
            # f32 lies ~8e-3 from f64; that distance is reported, beside two
            # f64 runs that tell f32 arithmetic from summation order
            c.log.clear()
            with bench():
                at_bench_tol[dtype] = mll_and_grad(mdl, dtype)
            c.log.clear()
            with bench(), settings.cg_tolerance(1e-4):
                loss, gvec, held_cg = mll_and_grad(mdl, dtype)
            with settings.max_cholesky_size(0), settings.cg_tolerance(1e-6), settings.max_cg_iterations(2000), \
                    torch.no_grad():
                iq = float(lo.inv_quad(mdl.train_operator(xh.to(dtype)), yh.to(dtype)[:, None]))
                mean_h = mdl.posterior_mean(xh.to(dtype), yh.to(dtype), xqh.to(dtype))
                _, var_h = mdl.posterior(xh.to(dtype), yh.to(dtype), xqh.to(dtype),
                                         generator=torch.Generator(device=c.dev).manual_seed(4))
            results[dtype] = (loss, gvec, iq, mean_h.double(), var_h.double(), mdl)
        for label, mdl, order in (
                ("points permuted", lo.SKIGPRegression(grid, dtype=torch.float64),
                 torch.randperm(N_SKI_HELD, device=c.dev, generator=g)),
                ("entries rounded to f32", RoundedSKI(grid, dtype=torch.float64), None)):
            c.log.clear()
            with bench():
                at_bench_tol[label] = mll_and_grad(mdl, torch.float64, order)
    finally:
        iqld.randn = real_randn
    with torch.no_grad():
        mdl64 = results[torch.float64][5]
        k64 = mdl64.train_operator(xh.double()).to_dense()
        ks64 = mdl64.covariance(xqh.double(), xh.double()).to_dense()
        kss64 = mdl64.covariance(xqh.double()).diagonal()
        chol = torch.linalg.cholesky(k64)
        del k64
        alpha = torch.cholesky_solve(yh.double()[:, None], chol)
        iq_exact = float(yh.double() @ alpha[:, 0])
        mean_exact = (ks64 @ alpha)[:, 0]
        var_exact = kss64 - torch.sum(ks64 * torch.cholesky_solve(ks64.mT, chol).mT, dim=-1)
        del chol
    (l32, g32, iq32, m32, v32, _), (l64, g64, iq64, m64, v64, _) = results[torch.float32], results[torch.float64]
    e_loss = abs(l32 - l64) / abs(l64)
    e_grad = float((g32 - g64).norm() / g64.norm())
    e_iq = abs(iq32 - iq_exact) / abs(iq_exact)
    e_mean = float((m32 - mean_exact).abs().max() / mean_exact.abs().max())
    e_var = float((v32 - var_exact).abs().max() / kss64.max())
    (b32, bg32, cg32), (b64, bg64, cg64) = at_bench_tol[torch.float32], at_bench_tol[torch.float64]
    f64_runs = "; ".join(
        f"f64 with {label} {b:.9f} ({abs(b - b64) / abs(b64):.2e}, gradient {float((bg - bg64).norm() / bg64.norm()):.2e}, "
        f"CG {cg})" for label, (b, bg, cg) in at_bench_tol.items() if isinstance(label, str))
    say(f"  hold at n={N_SKI_HELD}, grid {G_SKI_HELD}x{G_SKI_HELD}, same probes: at the bench's CG tolerance neg_mll f32 "
        f"{b32:.6f} / f64 {b64:.9f} ({abs(b32 - b64) / abs(b64):.2e}), gradient {float((bg32 - bg64).norm() / bg64.norm()):.2e} "
        f"of its norm, CG {cg32} / {cg64}; beside it {f64_runs} (reported, not held: 1e-3 does not hold for f32 at "
        f"the bench's tolerance); with CG to 1e-4 (CG {held_cg}) neg_mll f32 {l32:.6f} / f64 {l64:.6f} "
        f"({e_loss:.2e}), gradient {e_grad:.2e} of its norm; inv_quad {e_iq:.2e} (f64 port {abs(iq64 - iq_exact) / abs(iq_exact):.1e}) "
        f"and the posterior mean {e_mean:.2e} of max|mean| against a dense f64 Cholesky (held to 1e-3); the LOVE "
        f"variance {e_var:.2e} of the prior from the exact one (f64 port "
        f"{float((v64 - var_exact).abs().max() / kss64.max()):.2e}; reported)")
    if not max(e_loss, e_grad, e_iq, e_mean) <= 1e-3:
        fail("SKI at n = 20,000 disagrees with f64")
    if any(c.counts().values()):
        fail(f"config 4b launched {c.counts()}: it runs no kernel")
    del results, mdl64, ks64, alpha
    torch.cuda.empty_cache()


def _main_path_data(c, n=N, d=D):
    """Phase 5's data: x (n, d) ~ N(0, I) and y = sin(3 x_0) + 0.1 eps from
    the same seeded generator; the first n of phase 5's N points where n <= N
    and d = D, the same law drawn at the size asked for otherwise."""
    torch = c.torch
    rows = max(n, N)
    kg = torch.Generator(device=c.dev).manual_seed(10)
    x = torch.randn(rows, d, device=c.dev, generator=kg)
    y = torch.sin(3.0 * x[:, 0]) + 0.1 * torch.randn(rows, device=c.dev, generator=kg)
    return x[:n].contiguous(), y[:n].contiguous()


def phase_indexing(c) -> None:
    """16a. Indexing the exact-GP kernel operator at N = 100,000: K[idx] with
    1024 random rows stays a KernelLinearOperator whose mat-vecs at t = 1 and
    t = 11 launch K1, held against K1's plain version; K[:50000, :50000]
    stays a lazy symmetric kernel operator whose mat-vec launches K3, held
    against K3's plain version; K[idx, idx] and K[idx, perm(idx)] (pointwise)
    against the dense values of the 1024 points; the phase's peak device
    memory under INDEX_PEAK_BYTES (the dense K would take 40 GB)."""
    torch, lo, rbf = c.torch, c.lo, c.rbf
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    x, _ = _main_path_data(c)
    model = lo.ExactGPRegression(block_rows=8192, device=c.dev)
    K = model.covariance(x)
    ls, os_ = (float(v.detach()) for v in (K.params["lengthscale"], K.params["outputscale"]))
    g = torch.Generator(device=c.dev).manual_seed(90)
    idx = torch.randperm(N, device=c.dev, generator=g)[:M_INDEX]
    rows = K[idx]
    if type(rows) is not lo.KernelLinearOperator or tuple(rows.shape) != (M_INDEX, N) or rows.matvec_impl is None:
        fail(f"K[idx] is {type(rows).__name__} {tuple(rows.shape)}, not a fused kernel operator")
    block = K[: N // 2, : N // 2]
    if type(block) is not lo.KernelLinearOperator or not block.symmetric or tuple(block.shape) != (N // 2, N // 2):
        fail(f"K[:{N // 2}, :{N // 2}] is {type(block).__name__} {tuple(block.shape)}, not a symmetric kernel operator")
    xs = x / ls
    with torch.no_grad():
        for label, op, key, t, plain in [
            ("K[idx] @ v", rows, "K1", 1, lambda v: rbf.kernel_matvec_plain(xs[idx], xs, v)),
            ("K[idx] @ v", rows, "K1", 11, lambda v: rbf.kernel_matvec_plain(xs[idx], xs, v)),
            (f"K[:{N // 2}, :{N // 2}] @ v", block, "K3", 1,
             lambda v: rbf.kernel_matvec_plain(xs[: N // 2], xs[: N // 2], v)),
        ]:
            v = torch.randn(op.shape[-1], t, device=c.dev, generator=g)
            c.reset_counts()
            got = op @ v
            torch.cuda.synchronize()
            launched = c.counts()
            if launched[key] != 1 or sum(launched.values()) != 1:
                fail(f"{label} at t={t} launched {launched}: one {key} launch expected")
            c.launches[key] += 1
            ms = cuda_ms(torch, lambda: op @ v, 5)
            want = os_ * plain(v)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            say(f"  {label} t={t}: {key} once, {ms:.3f} ms, max_abs_err {err:.3e} against the plain version "
                f"(rel {err / scale:.2e})")
            if not err <= KERNEL_RTOL * scale:
                fail(f"{label} disagrees with {key}'s plain version")
        # pointwise reads: the diagonal (K[idx, idx]) and a permutation
        dense = os_ * torch.exp(-0.5 * torch.cdist(xs[idx].double(), xs[idx].double()) ** 2)
        perm = torch.randperm(M_INDEX, device=c.dev, generator=g)
        c.reset_counts()
        diag, pairs = K[idx, idx], K[idx, idx[perm]]
        if any(c.counts().values()):
            fail(f"pointwise reads launched {c.counts()}")
        ar = torch.arange(M_INDEX, device=c.dev)
        err = max(float((diag.double() - dense[ar, ar]).abs().max()), float((pairs.double() - dense[ar, perm]).abs().max()))
        say(f"  K[idx, idx] and K[idx, perm(idx)] ({M_INDEX} pointwise reads each): max_abs_err {err:.3e} against "
            f"the dense f64 values of the {M_INDEX} points")
        if not err <= 1e-5 * os_:
            fail("pointwise reads disagree with the dense values")
    peak = torch.cuda.max_memory_allocated()
    say(f"indexing (16a) N={N}: peak device memory over the phase {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} GiB above its start; the dense K would take {4 * N * N / 1e9:.0f} GB)")
    if not peak - base < INDEX_PEAK_BYTES:
        fail("indexing the kernel operator took more device memory than its lazy sub-operators need")
    del K, rows, block, x, xs, dense
    torch.cuda.empty_cache()


def phase_fantasy(c) -> None:
    """16b. The fantasy update at N = 100,000 + 64 (GPyTorch's
    get_fantasy_model): (K + s2 I).cat_rows(B, C) with B = k(x_new, x) and
    C = k(x_new, x_new) + s2 I, a lazy Cat of Cats (the operator carries no
    root), solved for [y; y_new] by CG, once unpreconditioned (the JAX
    package's default: a Cat has no preconditioner) and once under
    beta_features.default_preconditioner; each run's iterations, time, K3
    launches (one per iteration, on the top-left block) and relative
    residual through the operator.  The same two solves at n = 4096 held
    against an f64 Cholesky solve of the appended dense matrix, and
    add_low_rank and cat_rows on a root operator (the root route) against
    the dense result."""
    torch, lo, settings, rbf = c.torch, c.lo, c.settings, c.rbf
    from linear_operator_tpu_torch import beta_features

    torch.cuda.empty_cache()
    g = torch.Generator(device=c.dev).manual_seed(91)
    x_all, y_all = _main_path_data(c)
    model = lo.ExactGPRegression(block_rows=8192, device=c.dev)
    s2 = float(torch.nn.functional.softplus(model.raw_noise.detach()))

    def appended(n):
        x, y = x_all[:n], y_all[:n]
        x_new = torch.randn(M_FANTASY, D, device=c.dev, generator=g)
        y_new = torch.sin(3.0 * x_new[:, 0])
        with torch.no_grad():
            B = model.covariance(x_new, x).to_dense()  # the new rows, (m, n)
            C = model.covariance(x_new).to_dense() + s2 * torch.eye(M_FANTASY, device=c.dev)
            op = model.train_operator(x).cat_rows(B, C)
        return op, torch.cat([y, y_new])[:, None], (x, B, C)

    def solve(op, rhs, tol, iters, precondition):
        c.reset_counts()
        c.log.clear()
        with contextlib.ExitStack() as stack:
            for ctx in [settings.max_cholesky_size(0), settings.cg_tolerance(tol), settings.max_cg_iterations(iters),
                        settings.verbose_linalg(True), torch.no_grad(),
                        beta_features.default_preconditioner(precondition)]:
                stack.enter_context(ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = op.solve(rhs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k3 = c.counts()["K3"]
            c.launches["K3"] += k3
            resid = float((op @ sol - rhs).norm() / rhs.norm())
        return sol, wall, list(c.log.counts), k3, resid

    op, rhs, _ = appended(N)
    if not (type(op) is lo.CatLinearOperator and all(type(o) is lo.CatLinearOperator for o in op.operators)):
        fail(f"cat_rows without a root gave {type(op).__name__}, not the lazy Cat of Cats")
    for precondition in (False, True):
        sol, wall, iters, k3, resid = solve(op, rhs, FANTASY_TOL, FANTASY_ITERS, precondition)
        extra = 2 if precondition else 0  # the rangefinder's two sketches (t = 15)
        say(f"fantasy (16b) N={N}+{M_FANTASY} {'default_preconditioner' if precondition else 'unpreconditioned'}: "
            f"CG iterations {iters}, {wall:.3f} s, K3 launches {k3}, relative residual {resid:.3e} "
            f"(CG tolerance {FANTASY_TOL})")
        if not (torch.isfinite(sol).all() and len(iters) == 1 and k3 == iters[0] + extra):
            fail("the fantasy solve is not finite or did not run one K3 launch per CG iteration")
        if not resid <= 2 * FANTASY_TOL and iters[0] < FANTASY_ITERS:
            fail("the fantasy solve stopped above its tolerance")
    del op, sol

    # at n = 4096: against an f64 Cholesky solve of the appended matrix.  CG
    # stops at |r| <= tol |b|, so |x - x64| / |x64| <= kappa tol: held there,
    # and the true residual at 2 tol (the recurrence's f32 drift)
    op, rhs, (x, B, C) = appended(N_FANTASY_HELD)
    with torch.no_grad():
        K64 = model.covariance(x).to_dense().double() + s2 * torch.eye(N_FANTASY_HELD, device=c.dev, dtype=torch.float64)
        full = torch.cat([torch.cat([K64, B.double().mT], -1), torch.cat([B.double(), C.double()], -1)], -2)
        x64 = torch.cholesky_solve(rhs.double(), torch.linalg.cholesky(full))
        evals = torch.linalg.eigvalsh(full)
        kappa = float(evals[-1] / evals[0])
    for precondition in (False, True):
        sol, wall, iters, k3, resid = solve(op, rhs, FANTASY_HELD_TOL, 4 * N_FANTASY_HELD, precondition)
        err = float((sol.double() - x64).norm() / x64.norm())
        true_resid = float((full @ sol.double() - rhs.double()).norm() / rhs.double().norm())
        say(f"  n={N_FANTASY_HELD}+{M_FANTASY} {'default_preconditioner' if precondition else 'unpreconditioned'}: "
            f"CG iterations {iters}, relative residual {true_resid:.3e} (f64), |x - x_chol| / |x_chol| {err:.3e}, "
            f"held to kappa tol = {kappa:.3e} x {FANTASY_HELD_TOL}")
        if not (true_resid <= 2 * FANTASY_HELD_TOL and err <= kappa * FANTASY_HELD_TOL):
            fail("the fantasy solve disagrees with the f64 Cholesky solve")

    # the root route, in f64: a carried root is updated (add_low_rank joins
    # [L | V]; cat_rows builds the block-triangular root), none is computed
    n = N_FANTASY_ROOT
    with torch.no_grad():
        K64 = K64[:n, :n]
        Kop = lo.DenseLinearOperator(K64)
        rooted = Kop.with_factorization(Kop.cholesky())
        V = torch.randn(n, 3, device=c.dev, generator=g, dtype=torch.float64)
        Bn, Cn = B.double()[:, :n], C.double()
        low = rooted.add_low_rank(V)
        cat = rooted.cat_rows(Bn, Cn)
        full = torch.cat([torch.cat([K64, Bn.mT], -1), torch.cat([Bn, Cn], -1)], -2)
        e_low = float((low.to_dense() - (K64 + V @ V.mT)).abs().max() / K64.abs().max())
        e_cat = float((cat.to_dense() - full).abs().max() / full.abs().max())
    say(f"  root route n={n} (f64): add_low_rank -> {type(low).__name__}, max err {e_low:.3e}; cat_rows -> "
        f"{type(cat).__name__} with a root of {tuple(cat.root.shape)}, max err {e_cat:.3e} (of the largest entry)")
    if not (type(low) is lo.RootLinearOperator and type(cat) is lo.RootLinearOperator and max(e_low, e_cat) <= 1e-10):
        fail("add_low_rank or cat_rows on a carried root disagrees with the dense result")
    del op, K64, full, x64
    torch.cuda.empty_cache()


def phase_harness(c) -> None:
    """16c. The port's shipped property suite (linear_operator_tpu_torch.test)
    on the card: LinearOperatorTestCase with device="cuda" on a fused RBF
    KernelLinearOperator in f32 at n = 512 (K1, K2 and K3 must launch), a
    CatLinearOperator and a MulLinearOperator (float64, as the CPU suite's
    classes).  Any failure or error fails the run."""
    import io
    import unittest

    import numpy as np

    torch, lo = c.torch, c.lo
    from linear_operator_tpu_torch.test import LinearOperatorTestCase

    # tolerance key -> (largest |actual - expected|, largest share of the
    # limit atol + rtol |expected|, and of the harness's own limit) over the
    # kernel case's comparisons
    seen = {}
    own_limits = LinearOperatorTestCase.tolerances

    def share_of(diff, expected, rtol, atol):
        limit = atol + rtol * np.abs(expected)
        return float(np.max(diff[limit > 0] / limit[limit > 0])) if np.any(limit > 0) else 0.0

    class KeyedTolerances(dict):
        """The kernel case's tolerances; a read notes its key, so that the
        comparisons made at those values are credited to it (any other
        comparison, with limits of its own, to "explicit")."""

        key = None

        def __getitem__(self, key):
            self.key = key
            return super().__getitem__(key)

    class KernelOnCard(LinearOperatorTestCase):
        seed = 0
        device = str(c.dev)
        should_test_sample = False
        tolerances = KeyedTolerances({**LinearOperatorTestCase.tolerances, **HARNESS_KERNEL_TOLERANCES})

        def assertAllClose(self, actual, expected, rtol=1e-4, atol=1e-5, msg=None):
            key = self.tolerances.key
            if key is None or dict.__getitem__(self.tolerances, key) != {"rtol": rtol, "atol": atol}:
                key = "explicit"
            a, e = (np.asarray(v.detach().double().cpu() if torch.is_tensor(v) else v, dtype=np.float64)
                    for v in (actual, expected))
            if a.shape == e.shape and a.size:
                diff = np.abs(a - e)
                share = share_of(diff, e, rtol, atol)
                own = share_of(diff, e, **own_limits[key]) if key in own_limits else share
                before = seen.get(key, (0.0, 0.0, 0.0))
                seen[key] = (max(before[0], float(np.max(diff))), max(before[1], share), max(before[2], own))
            super().assertAllClose(actual, expected, rtol=rtol, atol=atol, msg=msg)
        # a jittered 8 x 8 x 8 grid: no point without neighbours, so that the
        # spectrum has no cluster at the outputscale (which a Lanczos root
        # from one start vector resolves once) and K stays well conditioned
        side = round(N_HARNESS ** (1 / 3))
        grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3) / (side - 1)
        x = grid + HARNESS_JITTER * np.random.default_rng(95).normal(size=grid.shape)

        def create_linear_op(self):
            return lo.rbf_kernel_operator(self.tensor(self.x, dtype=torch.float32), lengthscale=HARNESS_LS,
                                          outputscale=1.0)

        def evaluate_linear_op(self, op):
            x1, x2 = op.x1 / op.params["lengthscale"], op.x2 / op.params["lengthscale"]
            d2 = torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2, dim=-1)
            return op.params["outputscale"] * torch.exp(-0.5 * d2)

    def psd(seed, n):
        a = np.random.default_rng(seed).normal(size=(n, n))
        return a @ a.T + n * np.eye(n)

    class CatOnCard(LinearOperatorTestCase):
        seed = 1
        device = str(c.dev)
        full = psd(20, 7)

        def create_linear_op(self):
            f = self.tensor(self.full)
            top = lo.CatLinearOperator((lo.DenseLinearOperator(f[:4, :4]), lo.DenseLinearOperator(f[:4, 4:])), cat_dim=-1)
            bottom = lo.CatLinearOperator((lo.DenseLinearOperator(f[4:, :4]), lo.DenseLinearOperator(f[4:, 4:])),
                                          cat_dim=-1)
            return lo.CatLinearOperator((top, bottom), cat_dim=-2)

        def evaluate_linear_op(self, op):
            top, bottom = op.operators
            return torch.cat([torch.cat([b.to_dense() for b in blk.operators], -1) for blk in (top, bottom)], -2)

    class MulOnCard(LinearOperatorTestCase):
        seed = 4
        device = str(c.dev)
        should_call_cg = False
        la = np.random.default_rng(67).normal(size=(6, 6)) + 3 * np.eye(6)
        lb = np.random.default_rng(68).normal(size=(6, 6)) + 3 * np.eye(6)

        def create_linear_op(self):
            return lo.MulLinearOperator(lo.DenseLinearOperator(self.tensor(self.la)),
                                        lo.DenseLinearOperator(self.tensor(self.lb)))

        def evaluate_linear_op(self, op):
            la, lb = op.left_root.tensor, op.right_root.tensor
            return (la @ la.mT) * (lb @ lb.mT)

    # what the fused kernels' three-pass bf16 products cost the kernel case:
    # its mat-vecs (K3 at t = 4, K1 through the transpose) against the dense
    # f32 matrix, and the x-gradient (K2) against autograd through it
    probe = KernelOnCard("test_to_dense")
    probe.setUp()
    op = probe.create_linear_op()
    dense = probe.evaluate_linear_op(op)
    rhs = probe.randn(N_HARNESS, 4, dtype=torch.float32)
    with torch.no_grad():
        e_mm = float((op @ rhs - dense @ rhs).abs().max())
        e_tmm = float((op._t_matmul(rhs) - dense.mT @ rhs).abs().max())
    g_fused = probe._leaf_grads(op, lambda o: torch.sum(torch.sin(o @ rhs)))
    g_dense = probe._leaf_grads(op, lambda o: torch.sum(torch.sin(probe.evaluate_linear_op(o) @ rhs)))
    e_grad = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_fused, g_dense))
    say(f"harness (16c) kernel case n={N_HARNESS} f32 ls={HARNESS_LS}: |K v - dense v| {e_mm:.3e} (max|dense v| "
        f"{float((dense @ rhs).abs().max()):.3e}), transposed {e_tmm:.3e}; gradient max rel err {e_grad:.3e}; "
        f"tolerances beyond the harness's own: {HARNESS_KERNEL_TOLERANCES or 'none'}")

    for case in (KernelOnCard, CatOnCard, MulOnCard):
        c.reset_counts()
        stream = io.StringIO()
        t0 = time.perf_counter()
        # the kernel case's spectrum is flat (a well conditioned K): its
        # Lanczos root needs k = n
        with c.settings.max_root_decomposition_size(N_HARNESS):
            result = unittest.TextTestRunner(stream=stream, verbosity=0).run(
                unittest.TestLoader().loadTestsFromTestCase(case))
        wall = time.perf_counter() - t0
        launched = c.counts()
        bad = result.failures + result.errors
        say(f"harness (16c) {case.__name__}: {result.testsRun} tests in {wall:.1f} s, {len(result.failures)} failed, "
            f"{len(result.errors)} errors; launches {launched}")
        for test, trace in bad:
            say(f"  {test.id().rsplit('.', 1)[-1]}: " + trace.strip().splitlines()[-1][:400])
        if case is KernelOnCard:
            limits = KernelOnCard.tolerances
            for key in sorted(seen):
                err, share, own = seen[key]
                limit = dict.get(limits, key, "its own")
                widened = f" (widened; {own:.3f} of the harness's own)" if key in HARNESS_KERNEL_TOLERANCES else ""
                say(f"  kernel case, key {key}: largest |err| {err:.3e}, {share:.3f} of its limit {limit}{widened}")
        if bad:
            fail(f"the shipped harness failed on the card for {case.__name__}")
        if case is KernelOnCard and not all(launched[k] for k in ("K1", "K2", "K3")):
            fail(f"the kernel operator's harness run launched {launched}: K1, K2 and K3 must each launch")


def bench_context(settings):
    """bench.py's settings for the N = 1e5 MLL (bench.py:100-129)."""
    stack = contextlib.ExitStack()
    for c in [
        settings.max_cholesky_size(0), settings.num_trace_samples(PROBES),
        settings.max_cg_iterations(100), settings.cg_tolerance(1.0),
        settings.preconditioner_mode("auto"), settings.max_lanczos_quadrature_iterations(20),
    ]:
        stack.enter_context(c)
    return stack


@contextlib.contextmanager
def f32_probes(torch):
    """inv_quad_logdet's probes drawn in f32 and cast to the operator's
    dtype, so that an f64 run draws the f32 run's probes from the same seed
    (torch draws other numbers in f64).  inv_quad_logdet takes no probes and
    no probe dtype, as in the JAX package, so the draw is replaced where the
    module makes it."""
    mod = sys.modules["linear_operator_tpu_torch.functions._inv_quad_logdet"]
    real = mod.randn
    mod.randn = lambda shape, dtype, device, generator: real(shape, torch.float32, device, generator).to(dtype)
    try:
        yield
    finally:
        mod.randn = real


def phase_kernel_family(c) -> None:
    """17. The rest of the kernel operator on the card.

    (a) Matern-5/2, 3/2, 1/2 and RQ (alpha = 2) at config 3's data (N =
    100,000, d = 3), lengthscale (0.6, 0.7, 0.8), outputscale 0.693, noise
    0.127: each constructor's fused operator plus the noise through
    inv_quad_logdet and its backward under the bench's settings, cold and
    warm, then the predictive mean K(x*, x) K^-1 y at m = 64.  Launches by
    covariance id: K3 once per CG iteration with the covariance's id and
    none with RBF's (0), two K2 and one K3 in the backward, K1 in the mean.
    Matern-5/2 held against the plain path (use_fused_kernels=False) at N,
    the other three at N_FAMILY_HELD, on the same probes, to PATH_RTOL: the
    loss at the bench's settings, the gradient and the mean with CG to 1e-4;
    K3 (t = 11 and 1), K2 (t = 11) and K1 (t = 65) of each covariance and of
    RBF at the main path's shapes, held against their plain versions and
    timed with CUDA events.  (b) The blocked engine, no kernel: periodic and
    spectral mixture on a 1-D series of N_SERIES points (the per-solve dense
    f32 cache) and the LMC operator of examples/multitask_lmc.py (RBF (x)
    B B^T, T = 2) on N_LMC points, streamed in blocks; inv_quad_logdet and its
    backward, held against f64 on the same probes (f64 streams its blocks:
    the dense cache holds f32) to PATH_RTOL, the loss at the bench's
    settings and the gradient with CG to 1e-4; K1-K5 must not launch.  (c) A
    covariance registered at run time with CUDA bodies (Cauchy, 1 / (1 +
    d2)) on CUDA tensors at N_REGISTERED points: its own builds of K1, K3,
    K2 and K4 launch under its id, values within 1e-4 and gradients within
    1e-3 of f64, each kernel against its plain version; registered without
    CUDA bodies, every wrapper raises on CUDA tensors."""
    import functools

    torch, lo, settings, rbf, dev = c.torch, c.lo, c.settings, c.rbf, c.dev
    launches = getattr(c, "launches", None)
    wrappers = dict(K1=rbf.kernel_matvec, K3=rbf.kernel_matvec_sym, K2=rbf.kernel_weighted,
                    K4=rbf.rbf_build_sym_tiles, K5=rbf.rbf_matvec_sym_cached)

    def by_covar():
        return {k: dict(w.launches_by_covar) for k, w in wrappers.items() if k in ("K1", "K2", "K3")}

    rq = rbf.rq_tile_covar(2.0)
    family = {
        "matern52": (functools.partial(lo.matern_kernel_operator, nu=2.5), "matern52"),
        "matern32": (functools.partial(lo.matern_kernel_operator, nu=1.5), "matern32"),
        "matern12": (functools.partial(lo.matern_kernel_operator, nu=0.5), "matern12"),
        "rq": (functools.partial(lo.rq_kernel_operator, alpha=2.0), rq),
    }
    x, y = _main_path_data(c)
    x_star = torch.randn(M_STAR, D, device=dev, generator=torch.Generator(device=dev).manual_seed(12))
    ls = torch.tensor(FAMILY_LS, device=dev)

    def step(make, n, fused, *overrides):
        """inv_quad_logdet of make(x[:n]) + noise I at y[:n] under the
        bench's settings (and ``overrides``; probes from seed 1), (iq +
        logdet) / 2n, and its backward into the lengthscale, outputscale and
        noise; times and launches of each half."""
        leaves = [ls.clone(), torch.tensor(FAMILY_OS, device=dev), torch.tensor(FAMILY_NOISE, device=dev)]
        leaves = [t.requires_grad_() for t in leaves]
        c.reset_counts()
        c.log.clear()
        with bench_context(settings), settings.verbose_linalg(True), contextlib.ExitStack() as more:
            for o in overrides:
                more.enter_context(o)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            K = make(x[:n], lengthscale=leaves[0], outputscale=leaves[1], use_fused_kernels=fused)
            iq, ld = lo.inv_quad_logdet(K.add_diagonal(leaves[2]), y[:n, None], logdet=True,
                                        generator=torch.Generator().manual_seed(1))
            loss = 0.5 * (iq + ld) / n
            val = float(loss.detach())
            t1 = time.perf_counter()
            fwd, fwd_by, iters = c.counts(), by_covar(), list(c.log.counts)
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            grad = torch.cat([t.grad.double().reshape(-1) for t in leaves])
        bwd = {k: v - fwd[k] for k, v in c.counts().items()}
        bwd_by = {k: {i: v - fwd_by[k].get(i, 0) for i, v in d.items() if v - fwd_by[k].get(i, 0)}
                  for k, d in by_covar().items()}
        return dict(loss=val, grad=grad, fwd_s=t1 - t0, bwd_s=t2 - t1, fwd=fwd, fwd_by=fwd_by, bwd=bwd,
                    bwd_by=bwd_by, iters=iters)

    def mean(make, n, fused, *overrides):
        """The predictive mean K(x*, x) (K + noise I)^-1 y on the first n
        points under the bench's settings (and ``overrides``); its launches
        by covariance id and CG iterations."""
        c.reset_counts()
        c.log.clear()
        with bench_context(settings), settings.verbose_linalg(True), torch.no_grad(), \
                contextlib.ExitStack() as more:
            for o in overrides:
                more.enter_context(o)
            K = make(x[:n], lengthscale=ls, outputscale=FAMILY_OS, use_fused_kernels=fused)
            alpha = lo.solve(K.add_diagonal(torch.tensor(FAMILY_NOISE, device=dev)), y[:n, None])
            out = (make(x_star, x[:n], lengthscale=ls, outputscale=FAMILY_OS, use_fused_kernels=fused) @ alpha)[:, 0]
            torch.cuda.synchronize()
        return out, by_covar(), list(c.log.counts)

    say(f"kernel family (17a) N={N} d={D}, lengthscale {FAMILY_LS}, outputscale {FAMILY_OS}, noise {FAMILY_NOISE}:")
    for label, (make, name) in family.items():
        cid = rbf.TILE_COVARS[name].covar_id
        steps = [step(make, N, True) for _ in ("cold", "warm")]
        for tag, st in zip(("cold", "warm"), steps):
            say(f"  {label} ({tag}): loss {st['loss']:.8f}, forward {st['fwd_s']:.3f} s (CG iterations {st['iters']}, "
                f"launches by id {st['fwd_by']}), backward {st['bwd_s']:.3f} s (launches by id {st['bwd_by']}), "
                f"grad {st['grad'].tolist()}")
            if not (math.isfinite(st["loss"]) and torch.isfinite(st["grad"]).all()):
                fail(f"{label}: the loss or its gradient is not finite")
            if st["fwd_by"] != dict(K1={}, K2={}, K3={cid: sum(st["iters"])}) or not st["iters"]:
                fail(f"{label}: the forward did not make one K3 launch of id {cid} per CG iteration and nothing else")
            if st["bwd_by"] != dict(K1={}, K2={cid: 2}, K3={cid: 1}) or st["bwd"]["K4"] or st["bwd"]["K5"]:
                fail(f"{label}: the backward did not make two K2 launches and one K3 launch of id {cid}")
        mu, mean_by, mean_iters = mean(make, N, True)
        say(f"  {label} predictive mean m={M_STAR}: CG iterations {mean_iters}, launches by id {mean_by}")
        if mean_by != dict(K1={cid: 1}, K2={}, K3={cid: sum(mean_iters)}) or not torch.isfinite(mu).all():
            fail(f"{label}: the predictive mean did not make one K1 launch and one K3 launch per CG iteration")
        if launches is not None:
            for st in steps[:1]:
                for key in ("K1", "K2", "K3"):
                    launches[key] += st["fwd"][key] + st["bwd"][key]
            launches["K1"] += 1
            launches["K3"] += sum(mean_iters)
        # the hold: the fused path against the plain one, on the same probes,
        # as phase 6 holds RBF.  The gradient and the mean are held with CG
        # run to 1e-4: at the bench's tolerance of 1.0 CG stops after a few
        # iterations, and the kernels' three bf16 products move the
        # unconverged gradient and mean (reported)
        n = N if label == "matern52" else N_FAMILY_HELD
        fused = steps[0] if n == N else step(make, n, True)
        plain = step(make, n, False)
        rel = abs(fused["loss"] - plain["loss"]) / abs(plain["loss"])
        grel_bench = float((fused["grad"] - plain["grad"]).norm() / plain["grad"].norm())
        tight = (settings.cg_tolerance(1e-4), settings.max_cg_iterations(1000))
        fused_t, plain_t = step(make, n, True, *tight), step(make, n, False, *tight)
        grel = float((fused_t["grad"] - plain_t["grad"]).norm() / plain_t["grad"].norm())
        mu_f = mu if n == N else mean(make, n, True)[0]
        rel_bench = float((mu_f - mean(make, n, False)[0]).abs().max() / mu_f.abs().max())
        (mu_f, _, it_f), (mu_p, _, it_p) = mean(make, n, True, *tight), mean(make, n, False, *tight)
        rel_mu = float((mu_f - mu_p).abs().max() / mu_p.abs().max())
        say(f"  {label} held at n={n}: loss fused {fused['loss']:.8f}, plain {plain['loss']:.8f} "
            f"(plain forward {plain['fwd_s']:.3f} s, backward {plain['bwd_s']:.3f} s, CG iterations "
            f"{plain['iters']}), rel diff {rel:.2e}; gradient rel diff {grel:.2e} with CG to 1e-4 (iterations "
            f"fused {fused_t['iters']}, plain {plain_t['iters']}; plain forward {plain_t['fwd_s']:.3f} s, "
            f"backward {plain_t['bwd_s']:.3f} s; fused grad {fused_t['grad'].tolist()}, plain "
            f"{plain_t['grad'].tolist()}), {grel_bench:.2e} at the bench's tolerance (reported); predictive mean "
            f"rel diff {rel_mu:.2e} with CG to 1e-4 (iterations fused {it_f}, plain {it_p}), {rel_bench:.2e} at "
            f"the bench's tolerance (reported)")
        if not (rel <= PATH_RTOL and grel <= PATH_RTOL and rel_mu <= PATH_RTOL):
            fail(f"{label}: the fused path disagrees with the plain path")

    # the kernels at the main path's shapes, each covariance beside RBF's
    g = torch.Generator(device=dev).manual_seed(13)
    xs = x / ls
    v11, v1, v65, g11 = (torch.randn(N, t, device=dev, generator=g) for t in (PROBES + 1, 1, M_STAR + 1, PROBES + 1))
    family_ms = {}
    for name in ["rbf", *(n for _, n in family.values())]:
        k3 = rbf.kernel_matvec_sym(xs, v11, name)
        k1 = rbf.kernel_matvec(xs, xs, v65, name)
        wx, ws = rbf.kernel_weighted(xs, xs, g11, v11, name)
        errs = []
        for label, got, want in [("K3 t=11", k3, rbf.kernel_matvec_plain(xs, xs, v11, name)),
                                 ("K1 t=65", k1, rbf.kernel_matvec_plain(xs, xs, v65, name))]:
            torch.cuda.synchronize()
            errs.append(float((got - want).abs().max() / want.abs().max()))
        pwx, pws = rbf.kernel_weighted_plain(xs, xs, g11, v11, name)
        errs.append(max(float((wx - pwx).abs().max() / pwx.abs().max()), float((ws - pws).abs().max() / pws.abs().max())))
        ms = dict(K3=cuda_ms(torch, lambda: rbf.kernel_matvec_sym(xs, v11, name), 5),
                  K3_t1=cuda_ms(torch, lambda: rbf.kernel_matvec_sym(xs, v1, name), 5),
                  K2=cuda_ms(torch, lambda: rbf.kernel_weighted(xs, xs, g11, v11, name), 5),
                  K1=cuda_ms(torch, lambda: rbf.kernel_matvec(xs, xs, v65, name), 5))
        key = "rq" if name == rq else name
        family_ms[key] = ms
        say(f"  {key}: K3 {ms['K3']:.3f} ms (t = 11), {ms['K3_t1']:.3f} ms (t = 1); K2 {ms['K2']:.3f} ms (t = 11); "
            f"K1 {ms['K1']:.3f} ms (t = 65); relative error against the plain version: K3 {errs[0]:.2e}, "
            f"K1 {errs[1]:.2e}, K2 {errs[2]:.2e}")
        if not max(errs) <= KERNEL_RTOL:
            fail(f"{key}: a kernel disagrees with its plain version at the main path's shapes")
    c.family_ms = family_ms
    del xs, v11, v1, v65, g11, wx, ws, pwx, pws, k1, k3
    torch.cuda.empty_cache()

    _family_blocked(c)
    _family_registered(c)


def _family_blocked(c) -> None:
    """17b: periodic and spectral mixture on a 1-D series, and the LMC
    operator, on the blocked engine; held against f64 on the same probes."""
    torch, lo, settings, dev = c.torch, c.lo, c.settings, c.dev
    x, y = _main_path_data(c)
    say("blocked engine (17b), no kernel:")
    gs = torch.Generator(device=dev).manual_seed(14)
    t_series = torch.sort(10.0 * torch.rand(N_SERIES, 1, device=dev, generator=gs), dim=0).values
    y_series = torch.sin(2.0 * math.pi * t_series[:, 0]) + 0.1 * torch.randn(N_SERIES, device=dev, generator=gs)
    mix = dict(weights=torch.full((Q_MIXTURE,), 0.25, device=dev),
               means=torch.linspace(0.5, 2.0, Q_MIXTURE, device=dev)[:, None],
               scales=torch.full((Q_MIXTURE, 1), 0.2, device=dev))
    x_lmc, y_lmc_raw = x[:N_LMC, :2], torch.stack([y[:N_LMC], 0.7 * y[:N_LMC] + 0.2 * x[:N_LMC, 0]], dim=-1)

    def lmc_covar(x1, x2, lengthscale, outputscale, lmc_coeffs):
        k = lo.operators.rbf_covar(x1, x2, lengthscale, outputscale)
        return lo.KroneckerProductLinearOperator(lo.DenseLinearOperator(k),
                                                 lo.RootLinearOperator(lo.DenseLinearOperator(lmc_coeffs)))

    def series_op(kind, dtype, params):
        tt = t_series.to(dtype)
        thr = None if dtype == torch.float64 else 2**30
        if kind == "periodic":
            return lo.periodic_kernel_operator(tt, lengthscale=params[0], outputscale=params[1], period=1.0,
                                               materialize_threshold=thr)
        if kind == "spectral mixture":
            return lo.spectral_mixture_kernel_operator(tt, weights=params[0], means=mix["means"].to(dtype),
                                                       scales=params[1], materialize_threshold=thr)
        return lo.KernelLinearOperator(
            x_lmc.to(dtype), x_lmc.to(dtype),
            {"lengthscale": params[0], "outputscale": params[1],
             "lmc_coeffs": (torch.eye(2, device=dev) + 0.1).to(dtype)},
            covar_func=lmc_covar, num_outputs_per_input=(2, 2), symmetric=True, block_rows=4096,
            nonbatch_dims=(("lengthscale", 0), ("outputscale", 0), ("lmc_coeffs", 2)), materialize_threshold=None,
        )

    def blocked_step(kind, dtype, *overrides):
        if kind == "spectral mixture":
            params = [mix["weights"].to(dtype), mix["scales"].to(dtype)]
        elif kind == "periodic":
            params = [torch.tensor(0.5, dtype=dtype, device=dev), torch.tensor(FAMILY_OS, dtype=dtype, device=dev)]
        else:  # the LMC example's initial lengthscale and outputscale, softplus(0.5)
            params = [torch.tensor(math.log1p(math.exp(0.5)), dtype=dtype, device=dev) for _ in range(2)]
        params = [p.clone().requires_grad_() for p in params]
        yy = (y_lmc_raw.reshape(-1) if kind == "LMC" else y_series).to(dtype)
        op = series_op(kind, dtype, params)
        c.reset_counts()
        c.log.clear()
        with bench_context(settings), settings.verbose_linalg(True), f32_probes(torch), contextlib.ExitStack() as more:
            for o in overrides:
                more.enter_context(o)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iq, ld = lo.inv_quad_logdet(op.add_diagonal(torch.tensor(FAMILY_NOISE, dtype=dtype, device=dev)),
                                        yy[:, None], logdet=True, generator=torch.Generator().manual_seed(1))
            loss = 0.5 * (iq + ld) / yy.shape[0]
            val = float(loss.detach())
            t1 = time.perf_counter()
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        grad = torch.cat([gr.double().reshape(-1) for gr in grads])
        return dict(loss=val, grad=grad, fwd_s=t1 - t0, bwd_s=t2 - t1, counts=c.counts(), rows=yy.shape[0],
                    iters=list(c.log.counts))

    for kind in ("periodic", "spectral mixture", "LMC"):
        runs = [blocked_step(kind, torch.float32) for _ in ("cold", "warm")] + [blocked_step(kind, torch.float64)]
        f32, f64 = runs[1], runs[2]
        rel = abs(f32["loss"] - f64["loss"]) / abs(f64["loss"])
        grel = float((f32["grad"] - f64["grad"]).norm() / f64["grad"].norm())
        tight = [blocked_step(kind, dt, settings.cg_tolerance(1e-4), settings.max_cg_iterations(1000), settings.min_preconditioning_size(10**9))
                 for dt in (torch.float32, torch.float64)]
        trel = float((tight[0]["grad"] - tight[1]["grad"]).norm() / tight[1]["grad"].norm())
        say(f"  {kind} ({f32['rows']} rows): loss {f32['loss']:.8f}, f64 {f64['loss']:.8f}, rel diff {rel:.2e}; "
            f"gradient rel diff {grel:.2e} (reported), with CG to 1e-4 {trel:.2e} (CG iterations f32 {f32['iters']}, "
            f"f64 {f64['iters']}, to 1e-4 {tight[0]['iters']}, {tight[1]['iters']}); forward cold {runs[0]['fwd_s']:.3f} "
            f"s, warm {f32['fwd_s']:.3f} s, backward warm {f32['bwd_s']:.3f} s; f64 forward {f64['fwd_s']:.3f} s; "
            f"launches {f32['counts']}")
        if any(any(r["counts"].values()) for r in runs):
            fail(f"{kind}: a kernel launched on the blocked engine")
        if not (rel <= PATH_RTOL and trel <= PATH_RTOL and torch.isfinite(f32["grad"]).all()):
            fail(f"{kind}: the f32 blocked route disagrees with f64")
    torch.cuda.empty_cache()



def _family_registered(c) -> None:
    """17c: a covariance registered at run time with CUDA bodies is compiled
    into builds of K1, K3, K2 and K4 of its own and launches them under its
    id; one registered without them raises on CUDA tensors."""
    from linear_operator_tpu_torch import _build

    torch, rbf, dev = c.torch, c.rbf, c.dev
    wrappers = dict(K1=rbf.kernel_matvec, K3=rbf.kernel_matvec_sym, K2=rbf.kernel_weighted,
                    K4=rbf.rbf_build_sym_tiles)
    name = rbf.register_tile_covar("cauchy", lambda d2: 1.0 / (1.0 + d2), lambda d2: -1.0 / (1.0 + d2) ** 2,
                                   cuda_covar="1.0f / (1.0f + d2)",
                                   cuda_dcovar="-1.0f / ((1.0f + d2) * (1.0f + d2))")
    spec = rbf.TILE_COVARS[name]
    t0 = time.perf_counter()
    times = _build.build(["kernel_matvec", "kernel_matvec_sym", "kernel_weighted", "kernel_build_sym"], spec.header)
    build_s = time.perf_counter() - t0
    gr = torch.Generator(device=dev).manual_seed(15)
    x1, x2 = (torch.randn(N_REGISTERED, D, device=dev, generator=gr) for _ in range(2))
    v, w = (torch.randn(N_REGISTERED, PROBES + 1, device=dev, generator=gr) for _ in range(2))

    def registered(dtype, k1, k3):
        leaves = [t.to(dtype, copy=True).requires_grad_() for t in (x1, x2, v)]
        out = k1(*leaves, name)
        sym = k3(leaves[0], leaves[2], name)
        grads = torch.autograd.grad(torch.sum(out * w.to(dtype)) + torch.sum(sym * w.to(dtype)), leaves)
        return out.detach(), sym.detach(), grads

    c.reset_counts()
    got = registered(torch.float32, rbf.kernel_matvec, rbf.kernel_matvec_sym)
    torch.cuda.synchronize()
    by_id = {k: dict(wr.launches_by_covar) for k, wr in wrappers.items()}
    want = registered(torch.float64, rbf.kernel_matvec_plain, lambda x, u, cv: rbf.kernel_matvec_plain(x, x, u, cv))
    val_err = max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(got[:2], want[:2]))
    grad_err = max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(got[2], want[2]))
    # each kernel against its plain version on the same inputs, K4's tiles
    # within one bf16 ulp
    errs = [float((rbf.kernel_matvec(x1, x2, v, name) - rbf.kernel_matvec_plain(x1, x2, v, name)).abs().max()
                  / rbf.kernel_matvec_plain(x1, x2, v, name).abs().max()),
            float((rbf.kernel_matvec_sym(x1, v, name) - rbf.kernel_matvec_plain(x1, x1, v, name)).abs().max()
                  / rbf.kernel_matvec_plain(x1, x1, v, name).abs().max())]
    errs += [float((a - b).abs().max() / b.abs().max())
             for a, b in zip(rbf.kernel_weighted(x1, x2, w, v, name), rbf.kernel_weighted_plain(x1, x2, w, v, name))]
    tiles, plain_tiles = rbf.rbf_build_sym_tiles(x1, TILE, name), rbf.rbf_build_sym_tiles_plain(x1, TILE, name)
    ulp = int((tiles.view(torch.int16).int() - plain_tiles.view(torch.int16).int()).abs().max())
    refused = 0
    bare = rbf.register_tile_covar("cauchy_bare", spec.fn, spec.dfn)
    launched = sum(wr.launches for wr in wrappers.values())
    for call in (lambda: rbf.kernel_matvec(x1, x2, v, bare), lambda: rbf.kernel_matvec_sym(x1, v, bare),
                 lambda: rbf.kernel_weighted(x1, x2, w, v, bare), lambda: rbf.rbf_build_sym_tiles(x1, TILE, bare)):
        try:
            call()
        except ValueError:
            refused += 1
    say(f"registered covariance (17c) {name!r} (id {spec.covar_id}), n={N_REGISTERED}: its build {build_s:.1f} s wall "
        f"({', '.join(f'{k} {s:.1f} s' for k, s in times.items())}); launches by id {by_id}; against f64: values "
        f"{val_err:.2e}, gradients {grad_err:.2e}; against the plain versions: K1 {errs[0]:.2e}, K3 {errs[1]:.2e}, "
        f"K2 {max(errs[2:]):.2e}, K4 {ulp} bf16 ulp; registered without CUDA bodies: {refused} of 4 wrappers "
        f"refused CUDA tensors")
    if by_id != dict(K1={spec.covar_id: 2}, K3={spec.covar_id: 2}, K2={spec.covar_id: 4}, K4={}):
        fail("the registered covariance did not launch its own build of each kernel")
    if not (val_err <= 1e-4 and grad_err <= 1e-3 and max(errs) <= KERNEL_RTOL and ulp <= 1):
        fail("the registered covariance's kernels disagree with f64 or with their plain versions")
    if refused != 4 or sum(wr.launches for wr in wrappers.values()) != launched:
        fail("a covariance registered without CUDA bodies did not raise on CUDA tensors")


def _timed(torch, fn):
    """``fn()`` and its seconds on the host clock, the card synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _spread(seconds) -> str:
    """Median, min and max of a list of seconds, in ms."""
    ms = [1e3 * s for s in seconds]
    return f"median {statistics.median(ms):.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}, of {len(ms)})"


def _grad_vector(torch, model):
    """Every parameter's gradient, flattened in f64 (zeros where the loss
    does not reach it)."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).double().ravel()
                      for p in model.parameters()])


def _f32_against_f64(c, model, make_f64, loss_fn, label):
    """The loss and every gradient of ``model`` (f32) against an f64 copy of
    it (``make_f64()``, the state carried across), on the same inputs
    (``loss_fn(model, dtype)``): the loss's relative gap, the whole
    gradient's gap relative to its norm, and each parameter's, printed."""
    torch = c.torch
    twin = make_f64()
    twin.load_state_dict(model.state_dict())
    out = []
    for m, dtype in ((model, torch.float32), (twin, torch.float64)):
        m.zero_grad(set_to_none=True)
        loss = loss_fn(m, dtype)
        loss.backward()
        out.append((float(loss.detach()), _grad_vector(torch, m)))
    (l32, g32), (l64, g64) = out
    e_loss = abs(l32 - l64) / abs(l64)
    e_grad = float((g32 - g64).norm() / g64.norm())
    each = {name: float((p.grad.double() - q.grad).norm() / q.grad.norm())
            for (name, p), q in zip(model.named_parameters(), twin.parameters()) if q.grad is not None}
    say(f"  {label}: f32 loss {l32:.8g}, f64 {l64:.8g} (rel {e_loss:.2e}); gradient {e_grad:.2e} of its norm; "
        f"by parameter: " + ", ".join(f"{k} {v:.2e}" for k, v in each.items()))
    model.zero_grad(set_to_none=True)
    del twin
    return e_loss, e_grad, l32, l64


def phase_sgpr(c) -> None:
    """18a. SGPR (Titsias 2009) at N = 1,000,000, d = 3, m = 512 inducing
    points: neg_elbo and its backward (gradients to z and the
    hyperparameters) through the exact Woodbury forms of the
    LowRankRootAddedDiag operator, three Adam steps, the posterior at 1024
    query points; no kernel launch, no linear_cg, no Lanczos, no Cholesky
    but L_mm's and the posterior's m x m ones; each part's time and the peak
    device memory.  Held: f32 against f64 on the card at n = 100,000 (the
    first rows), the loss to SGPR_LOSS_ATOL nats a point and the gradient to
    SGPR_GRAD_RTOL of its norm (f32's K_mm at m = 512 takes
    psd_safe_cholesky's jitter; the trace term is a difference of large
    sums)."""
    torch, lo, settings = c.torch, c.lo, c.settings
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = _main_path_data(c, N_SGPR)
    gq = torch.Generator(device=c.dev).manual_seed(180)
    xq = torch.randn(M_QUERY, D, device=c.dev, generator=gq)
    model = lo.SGPRRegression(x, M_SGPR, device=c.dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    c.reset_counts()
    c.log.clear()
    with settings.verbose_linalg(True):
        loss, fwd_s = _timed(torch, lambda: model.neg_elbo(x, y))
        _, bwd_s = _timed(torch, loss.backward)
        first = float(loss.detach())
        grads = {name: float(p.grad.norm()) for name, p in model.named_parameters()}
        steps, losses = [], []
        for _ in range(ADAM_STEPS):
            def adam_step():
                opt.zero_grad()
                step_loss = model.neg_elbo(x, y)
                step_loss.backward()
                opt.step()
                return float(step_loss.detach())
            value, s = _timed(torch, adam_step)
            steps.append(s)
            losses.append(value)
        with torch.no_grad():
            (mean, var), post_s = _timed(torch, lambda: model.posterior(x, y, xq))
    launched, names, iters = c.counts(), list(c.log.names), list(c.log.counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"SGPR (18a) N={N_SGPR} d={D} m={M_SGPR}: neg_elbo {first:.8f}, forward {fwd_s * 1e3:.3f} ms, backward "
        f"{bwd_s * 1e3:.3f} ms, gradient norms {', '.join(f'{k} {v:.3e}' for k, v in grads.items())}; Adam steps "
        f"{_spread(steps)}, losses {losses}; posterior at {M_QUERY} points {post_s * 1e3:.3f} ms; launches "
        f"{launched}; solvers {sorted(set(names))} ({len(names)} calls); peak device memory {peak:.3f} GiB")
    if any(launched.values()) or iters or "linear_cg" in names or "lanczos_tridiag" in names:
        fail("the SGPR path launched a kernel or ran CG or Lanczos: it must run the Woodbury closed forms alone")
    if set(names) - {"psd_safe_cholesky"}:
        fail(f"the SGPR path ran {sorted(set(names))}: only m x m Cholesky factors are expected")
    if not (math.isfinite(first) and all(math.isfinite(v) and v > 0 for v in grads.values())
            and all(math.isfinite(v) for v in losses) and losses[-1] < first):
        fail("the SGPR step is not finite, leaves a parameter without a gradient, or Adam did not lower the loss")
    if not (torch.isfinite(mean).all() and torch.isfinite(var).all() and bool((var >= 0).all())):
        fail("the SGPR posterior is not finite or has a negative variance")
    del model, opt, loss, x, y
    torch.cuda.empty_cache()
    xh, yh = _main_path_data(c, N_SGPR_HELD)
    held = lo.SGPRRegression(xh, M_SGPR, device=c.dev)
    e_loss, e_grad, l32, l64 = _f32_against_f64(
        c, held, lambda: lo.SGPRRegression(xh.double(), M_SGPR, device=c.dev),
        lambda m, dt: m.neg_elbo(xh.to(dt), yh.to(dt)), f"held at n={N_SGPR_HELD}")
    if not (abs(l32 - l64) <= SGPR_LOSS_ATOL and e_grad <= SGPR_GRAD_RTOL):
        fail("SGPR in f32 disagrees with f64 beyond the stated tolerances")
    del held, xh, yh
    torch.cuda.empty_cache()


def _svgp_train(c, model, x, target, label):
    """SVGP_STEPS minibatch steps of ``model.neg_elbo(..., num_data=N)`` with
    Adam, each timed on the host clock; then f32 against f64 on one more
    minibatch at the trained parameters: reported with the model's jitter,
    held with both at SVGP_HELD_JITTER (f32's K_zz must take no more), and
    the held f32 model again with TF32 products allowed, which the hold must
    see."""
    from linear_operator_tpu_torch.utils.cholesky import psd_safe_cholesky_ex

    torch = c.torch
    n = x.shape[0]
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    gb = torch.Generator(device=c.dev).manual_seed(181)
    steps, losses = [], []
    for _ in range(SVGP_STEPS):
        idx = torch.randint(0, n, (B_SVGP,), device=c.dev, generator=gb)

        def step():
            opt.zero_grad()
            loss = model.neg_elbo(x[idx], target[idx], num_data=n)
            loss.backward()
            opt.step()
            return float(loss.detach())

        value, s = _timed(torch, step)
        steps.append(s)
        losses.append(value)
    say(f"{label}: {SVGP_STEPS} steps of B={B_SVGP} (num_data={n}): first {steps[0] * 1e3:.3f} ms, then "
        f"{_spread(steps[1:])}; loss {losses[0]:.6g} -> {losses[-1]:.6g}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        fail(f"{label}: the minibatch steps are not finite or did not lower the loss")
    idx = torch.randint(0, n, (B_SVGP,), device=c.dev, generator=gb)
    xb, tb = x[idx], target[idx]
    m = model.z.shape[0]

    def copy(dtype, jitter):
        twin = type(model)(xb.to(dtype), m, jitter=jitter, device=c.dev, **_svgp_kwargs(model))
        twin.load_state_dict(model.state_dict())
        return twin

    def loss_fn(mdl, dtype):
        return mdl.neg_elbo(xb.to(dtype), tb.to(dtype), num_data=n)

    where = "one minibatch at the trained parameters"
    _f32_against_f64(c, model, lambda: copy(torch.float64, model.jitter), loss_fn,
                     f"{where}, f64 at the model's jitter {model.jitter:g} (reported)")
    held = copy(torch.float32, SVGP_HELD_JITTER)
    with torch.no_grad():
        ls, os_, _ = held._hyp()
        k_zz = held.covar_func(held.z, held.z, lengthscale=ls, outputscale=os_)
        took = float(psd_safe_cholesky_ex(k_zz + SVGP_HELD_JITTER * torch.eye(m, device=c.dev)).jitter)
    e_loss, e_grad, _, _ = _f32_against_f64(c, held, lambda: copy(torch.float64, SVGP_HELD_JITTER), loss_fn,
                                            f"{where}, both at jitter {SVGP_HELD_JITTER:g} (held; f32's factor took "
                                            f"{took:g} more)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        c_loss, c_grad, _, _ = _f32_against_f64(c, held, lambda: copy(torch.float64, SVGP_HELD_JITTER), loss_fn,
                                                f"{where}, both at jitter {SVGP_HELD_JITTER:g}, control: f32 with "
                                                f"TF32 products allowed")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if took:
        fail(f"{label}: f32's K_zz needs more jitter than {SVGP_HELD_JITTER:g}")
    if not (e_loss <= SVGP_LOSS_RTOL and e_grad <= SVGP_GRAD_RTOL):
        fail(f"{label} in f32 disagrees with f64 beyond the stated tolerances")
    if c_loss <= SVGP_LOSS_RTOL and c_grad <= SVGP_GRAD_RTOL:
        fail(f"{label}: the hold does not see TF32 products (the control passes it)")


def _svgp_kwargs(model):
    return {"likelihood": model.likelihood} if hasattr(model, "likelihood") else {}


def phase_svgp(c) -> None:
    """18b. SVGP regression (Hensman et al. 2013) with N = 1,000,000 points on
    the device, m = 1024 inducing points, minibatches of 1024: 50 steps of
    neg_elbo(..., num_data=N).backward() and Adam, timed a step; one
    full-data predictive over the N points (no_grad); posterior_distribution
    at 1024 points and its log_prob of the noiseless target there (by
    Cholesky: max_cholesky_size(1024)).  No kernel launch.  Held: f32
    against f64 on one minibatch at the trained parameters, both at
    SVGP_HELD_JITTER, the loss to SVGP_LOSS_RTOL and the gradient to
    SVGP_GRAD_RTOL of its norm, and the same f32 model with TF32 products
    allowed must exceed one of them; against f64 at the model's own jitter,
    reported."""
    torch, lo = c.torch, c.lo
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = _main_path_data(c, N_SVGP)
    model = lo.SVGPRegression(x, M_SVGP, device=c.dev)
    c.reset_counts()
    _svgp_train(c, model, x, y, f"SVGP regression (18b) N={N_SVGP} m={M_SVGP}")
    with torch.no_grad():
        (mean, var), pred_s = _timed(torch, lambda: model.predictive(x))
        rmse = float(torch.sqrt(torch.mean((mean - y) ** 2)))
        xq = torch.randn(M_QUERY, D, device=c.dev, generator=torch.Generator(device=c.dev).manual_seed(182))
        mvn, dist_s = _timed(torch, lambda: model.posterior_distribution(xq))
        # the 1024 x 1024 posterior covariance is nearly singular (K_ss less
        # its explained part, plus the jitter): Cholesky, not CG, at this size
        with c.settings.max_cholesky_size(M_QUERY):
            lp, lp_s = _timed(torch, lambda: mvn.log_prob(torch.sin(3.0 * xq[:, 0])))
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  predictive over the N={N_SVGP} points {pred_s * 1e3:.3f} ms (RMSE against y {rmse:.4f}); "
        f"posterior_distribution at {M_QUERY} points {dist_s * 1e3:.3f} ms, its log_prob {float(lp):.4f} in "
        f"{lp_s * 1e3:.3f} ms; launches {c.counts()}; peak device memory {peak:.3f} GiB")
    if any(c.counts().values()):
        fail("SVGP launched a kernel: it runs PyTorch's dense products alone")
    if not (torch.isfinite(mean).all() and bool((var > 0).all()) and math.isfinite(float(lp))):
        fail("the SVGP predictive or the posterior distribution's log_prob is not finite")
    del model, x, y, mean, var, mvn
    torch.cuda.empty_cache()


def phase_classification(c) -> None:
    """18c. SVGPClassification (probit and logit, Q = 20 Gauss-Hermite
    points) and SVGPPoissonRegression at 18b's sizes: labels y > 0, counts
    drawn from a seeded Poisson of rate exp(sin(3 x_0)); each trained as 18b
    (steps timed, f32 against f64 on one minibatch at the trained
    parameters, the same tolerances), then predict_proba or predict_rate
    over the N points.  No kernel launch."""
    torch, lo = c.torch, c.lo
    torch.cuda.empty_cache()
    x, y = _main_path_data(c, N_SVGP)
    labels = (y > 0).to(x.dtype)
    rate = torch.exp(torch.sin(3.0 * x[:, 0]))
    counts = torch.poisson(rate, generator=torch.Generator(device=c.dev).manual_seed(183))
    c.reset_counts()
    for label, model, target in [
        ("probit", lo.SVGPClassification(x, M_SVGP, likelihood="probit", device=c.dev), labels),
        ("logit", lo.SVGPClassification(x, M_SVGP, likelihood="logit", device=c.dev), labels),
        ("poisson", lo.SVGPPoissonRegression(x, M_SVGP, device=c.dev), counts),
    ]:
        _svgp_train(c, model, x, target, f"SVGP {label} (18c) N={N_SVGP} m={M_SVGP}")
        with torch.no_grad():
            if label == "poisson":
                out, s = _timed(torch, lambda: model.predict_rate(x))
                quality = f"mean |rate - true rate| / true rate {float(torch.mean((out - rate).abs() / rate)):.4f}"
                ok = bool((out > 0).all())
            else:
                out, s = _timed(torch, lambda: model.predict_proba(x))
                quality = f"accuracy {float(((out >= 0.5).to(x.dtype) == labels).to(torch.float64).mean()):.4f}"
                ok = bool(((out >= 0) & (out <= 1)).all())
        say(f"  {'predict_rate' if label == 'poisson' else 'predict_proba'} over the N={N_SVGP} points "
            f"{s * 1e3:.3f} ms, {quality}")
        if not (ok and torch.isfinite(out).all()):
            fail(f"SVGP {label}: the predictions are not finite or out of range")
        del model, out
        torch.cuda.empty_cache()
    if any(c.counts().values()):
        fail("the classification and Poisson models launched a kernel")
    del x, y, labels, rate, counts
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _eigh_timer(torch):
    """torch.linalg.eigh, inside the block, timed call by call with CUDA
    events; yields the list of (shape, ms), filled when the block ends."""
    real, events, seen = torch.linalg.eigh, [], []

    def timed(a, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(a, *args, **kwargs)
        end.record()
        events.append((tuple(a.shape), start, end))
        return out

    torch.linalg.eigh = timed
    try:
        yield seen
    finally:
        torch.linalg.eigh = real
        torch.cuda.synchronize()
        seen.extend((shape, start.elapsed_time(end)) for shape, start, end in events)


def phase_multitask(c) -> None:
    """18d. The multitask GP (Bonilla et al. 2008) at n = 10,000, T = 4 tasks,
    rank 2, d = 3 (nT = 40,000 rows): neg_mll(...).backward() through the
    Kronecker closed forms (the factors' eigendecompositions), cold and
    warm, with the share of the step spent in eigh; posterior_mean and the
    LOVE posterior at 1024 query points.  No kernel launch, no CG.  Held
    against f64 at n = 2000: the loss to 1e-4 and the posteriors to 1e-3 of
    their largest entry; the f32 gradient reported (its eigenvector
    derivatives meet gaps of f32 rounding: ROADMAP.md queue 3)."""
    torch, lo, settings = c.torch, c.lo, c.settings
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, _ = _main_path_data(c, N_MT)
    gm = torch.Generator(device=c.dev).manual_seed(184)
    ys = torch.stack([torch.sin(3.0 * x[:, 0] + i) for i in range(T_MT)], dim=-1)
    ys = ys + 0.1 * torch.randn(N_MT, T_MT, device=c.dev, generator=gm)
    xq = torch.randn(M_QUERY, D, device=c.dev, generator=gm)
    model = lo.MultitaskGPRegression(T_MT, RANK_MT, device=c.dev)
    c.reset_counts()
    c.log.clear()
    runs = []
    with settings.verbose_linalg(True):
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            with _eigh_timer(torch) as eighs:
                loss, fwd_s = _timed(torch, lambda: model.neg_mll(x, ys))
                _, bwd_s = _timed(torch, loss.backward)
            runs.append((float(loss.detach()), fwd_s, bwd_s, list(eighs)))
        with torch.no_grad():
            pm, pm_s = _timed(torch, lambda: model.posterior_mean(x, ys, xq))
            (mean, var), post_s = _timed(torch, lambda: model.posterior(x, ys, xq))
    for label, (value, fwd_s, bwd_s, eighs) in zip(("cold", "warm"), runs):
        eigh_ms = sum(ms for _, ms in eighs)
        say(f"multitask (18d, {label}) n={N_MT} T={T_MT} rank={RANK_MT} (nT={N_MT * T_MT}): neg_mll {value:.8f}, "
            f"forward {fwd_s * 1e3:.3f} ms, backward {bwd_s * 1e3:.3f} ms; eigh {len(eighs)} calls "
            f"({', '.join(f'{s} {ms:.3f} ms' for s, ms in eighs)}), {eigh_ms:.3f} ms, "
            f"{100 * eigh_ms / (1e3 * (fwd_s + bwd_s)):.1f}% of the step")
    _, fwd_s, bwd_s, eighs = runs[1]
    say(f"  posterior_mean at {M_QUERY} points {pm_s * 1e3:.3f} ms, LOVE posterior {post_s * 1e3:.3f} ms; "
        f"launches {c.counts()}; solvers {sorted(set(c.log.names))}; CG {c.log.counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if any(c.counts().values()) or c.log.counts or "lanczos_tridiag" in c.log.names:
        fail("the multitask model launched a kernel or ran CG or Lanczos: it must run the Kronecker closed forms")
    if not (all(math.isfinite(r[0]) for r in runs) and all(torch.isfinite(p.grad).all() for p in model.parameters())
            and torch.isfinite(pm).all() and torch.isfinite(mean).all() and bool((var >= 0).all())):
        fail("the multitask step or posterior is not finite")
    if tuple(mean.shape) != (M_QUERY, T_MT) or float((pm - mean).abs().max()) > 1e-3 * float(pm.abs().max()):
        fail("the multitask LOVE posterior's mean is not posterior_mean's")
    del model, x, ys, loss
    torch.cuda.empty_cache()
    # held against f64 at n = N_MT_HELD
    xh = _main_path_data(c, N_MT_HELD)[0]
    yh = torch.stack([torch.sin(3.0 * xh[:, 0] + i) for i in range(T_MT)], dim=-1)
    out = []
    for dtype in (torch.float32, torch.float64):
        m = lo.MultitaskGPRegression(T_MT, RANK_MT, dtype=dtype, device=c.dev)
        xd, yd, xqd = xh.to(dtype), yh.to(dtype), xq.to(dtype)
        loss = m.neg_mll(xd, yd)
        loss.backward()
        with torch.no_grad():
            out.append((float(loss.detach()), _grad_vector(torch, m), m.posterior_mean(xd, yd, xqd).double(),
                        *(t.double() for t in m.posterior(xd, yd, xqd))))
    (l32, g32, *p32), (l64, g64, *p64) = out
    e_loss = abs(l32 - l64) / abs(l64)
    e_post = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(p32, p64))
    say(f"  held at n={N_MT_HELD}: f32 loss {l32:.8f}, f64 {l64:.8f} (rel {e_loss:.2e}); posterior_mean, mean and "
        f"variance {e_post:.2e} of their largest entries; the f32 gradient {float((g32 - g64).norm() / g64.norm()):.2e} "
        f"of its norm (reported: f32 eigenvector derivatives), f32 {g32.tolist()[:2]}, f64 {g64.tolist()[:2]} "
        f"(lengthscale, outputscale)")
    if not (e_loss <= 1e-4 and e_post <= 1e-3):
        fail("the multitask model in f32 disagrees with f64")
    del out, xh, yh
    torch.cuda.empty_cache()


def phase_dkl(c) -> None:
    """18e. Deep kernel learning (Wilson et al. 2016) at N = 100,000, d_in =
    8, hidden (1000, 1000, 500, 50, 2), the fused kernels on the 2-d
    features.  A training step neg_mll(...).backward() under the bench's
    settings: K3 once per CG iteration in the forward; the backward's
    gradient reaches the MLP through the kernel operator's data leaves: two
    K2 launches and one K3 (the bilinear form's own mat-vec), a nonzero
    gradient on the first layer's weights.  Held against the plain path on
    the same probes: the loss to PATH_RTOL (its first-layer gradient
    reported); at each noise of DKL_NOISES the first layer's weight gradient
    of the inverse quadratic term y^T K^-1 y / 2n, with CG to
    DKL_HELD_CG_TOL, against the plain path, itself and f64, reported; at
    DKL_HELD_NOISE it and the whole loss's, to DKL_GRAD_RTOL of its norm.
    Then three Adam steps; the
    posterior at m = 64 (K1); posterior_cache under the LOVE settings (K3
    at t = 1, once per CG iteration and per Lanczos step) and
    posterior_from_cache at 1024 queries (two K1 launches)."""
    torch, lo, settings = c.torch, c.lo, c.settings
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = _main_path_data(c, N_DKL, D_DKL)
    gq = torch.Generator(device=c.dev).manual_seed(185)
    x64, xq = (torch.randn(m, D_DKL, device=c.dev, generator=gq) for m in (M_STAR, M_QUERY))

    def make(fused):
        return lo.DeepKernelGPRegression(D_DKL, HIDDEN_DKL, generator=torch.Generator().manual_seed(186),
                                         device=c.dev, block_rows=8192, use_fused_kernels=fused)

    fused = make(True)
    mlp_s = _timed(torch, lambda: fused.features(x))[1]

    def train_step(model, seed, *overrides, inv_quad=False):
        """One step on ``model`` (its own dtype) under the bench's settings
        and ``overrides``: the negative MLL with probes from ``seed``, or with
        ``inv_quad`` its inverse quadratic term alone, y^T K^-1 y / 2n by one
        preconditioned CG solve, which draws nothing; the loss, the first
        layer's weight gradient, the launches and the CG iterations."""
        dt = model.mlp[0].weight.dtype
        xx, yy = x.to(dt), y.to(dt)

        def loss_fn():
            if inv_quad:
                return 0.5 * lo.inv_quad(model.train_operator(xx), yy[:, None]) / yy.shape[0]
            return model.neg_mll(xx, yy, generator=torch.Generator().manual_seed(seed))

        model.zero_grad(set_to_none=True)
        c.reset_counts()
        c.log.clear()
        with bench_context(settings), settings.verbose_linalg(True), contextlib.ExitStack() as more:
            for o in overrides:
                more.enter_context(o)
            loss, fwd_s = _timed(torch, loss_fn)
            fwd, iters = c.counts(), list(c.log.counts)
            _, bwd_s = _timed(torch, loss.backward)
        bwd = {k: v - fwd[k] for k, v in c.counts().items()}
        w1 = model.mlp[0].weight.grad.double().clone()
        return dict(loss=float(loss.detach()), fwd_s=fwd_s, bwd_s=bwd_s, fwd=fwd, bwd=bwd, iters=iters,
                    bwd_iters=list(c.log.counts)[len(iters):], w1=w1)

    steps = {label: train_step(fused, 1) for label in ("cold", "warm")}
    for label, st in steps.items():
        say(f"DKL training step (18e, {label}) N={N_DKL} d_in={D_DKL} hidden={HIDDEN_DKL}: loss {st['loss']:.8f}, "
            f"forward {st['fwd_s'] * 1e3:.3f} ms (CG iterations {st['iters']}, launches {st['fwd']}), backward "
            f"{st['bwd_s'] * 1e3:.3f} ms (launches {st['bwd']}), |grad W1| {float(st['w1'].norm()):.4e}")
        if st["fwd"] != dict(K1=0, K3=sum(st["iters"]), K2=0, K4=0, K5=0) or st["fwd"]["K3"] == 0:
            fail("the DKL step's forward did not make one K3 launch per CG iteration and nothing else")
        if st["bwd"] != dict(K1=0, K3=1, K2=2, K4=0, K5=0):
            fail("the DKL step's backward did not make two K2 launches and one K3 launch")
        if not (math.isfinite(st["loss"]) and torch.isfinite(st["w1"]).all() and float(st["w1"].abs().max()) > 0):
            fail("the DKL step's loss or the first layer's gradient is not finite and nonzero")
    c.launches["K3"] += steps["cold"]["fwd"]["K3"] + steps["cold"]["bwd"]["K3"]
    c.launches["K2"] += steps["cold"]["bwd"]["K2"]
    plain = make(False)
    plain.load_state_dict(fused.state_dict())
    twin = lo.DeepKernelGPRegression(D_DKL, HIDDEN_DKL, dtype=torch.float64, device=c.dev, block_rows=8192,
                                     use_fused_kernels=False)
    twin.load_state_dict(fused.state_dict())

    def gap(a, b):
        return abs(a["loss"] - b["loss"]) / abs(b["loss"]), float((a["w1"] - b["w1"]).norm() / b["w1"].norm())

    # the hold: fused against plain on the same probes.  At the model's noise
    # the loss is held; the first layer's weight gradient is reported (see
    # DKL_NOISES: at that noise the fused path's lies ~1e-2 from f64 however
    # far CG runs).  The inverse quadratic term's gradient (CG to DKL_HELD_CG_TOL, nothing
    # drawn) at each noise of DKL_NOISES: fused against plain, against
    # itself and against f64, and plain f32 against f64; at DKL_HELD_NOISE,
    # where f32 is accurate, it and the whole loss's gradient are held
    ref = train_step(plain, 1)
    (e_loss, e_w1), (s_loss, s_w1) = gap(steps["warm"], ref), gap(steps["cold"], steps["warm"])
    say(f"  plain path on the same probes: loss {ref['loss']:.8f}, forward {ref['fwd_s'] * 1e3:.3f} ms, backward "
        f"{ref['bwd_s'] * 1e3:.3f} ms, launches {ref['fwd']} / {ref['bwd']}; the MLP's forward alone "
        f"{mlp_s * 1e3:.3f} ms; fused to plain: loss {e_loss:.2e} (held), first layer's weight gradient {e_w1:.2e} "
        f"of its norm (reported); the fused path against itself (cold to warm): {s_loss:.2e}, {s_w1:.2e}")
    if e_loss > PATH_RTOL:
        fail("the DKL loss on the fused path disagrees with the plain path")
    tight = (settings.cg_tolerance(DKL_HELD_CG_TOL), settings.max_cg_iterations(DKL_HELD_CG_MAX))
    trained = {k: v.clone() for k, v in fused.state_dict().items()}
    for noise in DKL_NOISES:
        with torch.no_grad():
            for mdl in (fused, plain, twin):
                mdl.gp.raw_noise.fill_(math.log(math.expm1(noise - 1e-6)))
        runs = {k: train_step(mdl, 1, *tight, inv_quad=True)
                for k, mdl in (("fused", fused), ("again", fused), ("plain", plain), ("f64", twin))}
        gaps = {"fused to plain": gap(runs["fused"], runs["plain"]),
                "the fused path against itself": gap(runs["again"], runs["fused"]),
                "fused to plain f64": gap(runs["fused"], runs["f64"]),
                "plain f32 to plain f64": gap(runs["plain"], runs["f64"])}
        say(f"  noise {noise:g}, the inverse quadratic term with CG to {DKL_HELD_CG_TOL:g}: CG iterations "
            + ", ".join(f"{k} {r['iters']}" for k, r in runs.items())
            + f"; plain {runs['plain']['fwd_s'] + runs['plain']['bwd_s']:.3f} s, f64 "
            f"{runs['f64']['fwd_s'] + runs['f64']['bwd_s']:.3f} s; loss and first layer's weight gradient: "
            + ", ".join(f"{k} {a:.2e}, {b:.2e}" for k, (a, b) in gaps.items()))
        if max(r["iters"][0] for r in runs.values()) >= DKL_HELD_CG_MAX:
            fail(f"DKL's CG did not reach {DKL_HELD_CG_TOL:g} in {DKL_HELD_CG_MAX} iterations")
        if noise == DKL_HELD_NOISE:
            whole = gap(train_step(fused, 1, *tight), train_step(plain, 1, *tight))
            say(f"  noise {noise:g}, the whole loss on the same probes: fused to plain {whole[0]:.2e}, {whole[1]:.2e}")
            if not (gaps["fused to plain"][1] <= DKL_GRAD_RTOL and whole[1] <= DKL_GRAD_RTOL):
                fail("the DKL gradient on the fused path disagrees with the plain path")
    fused.load_state_dict(trained)
    del plain, twin, ref
    torch.cuda.empty_cache()
    # three Adam steps
    opt = torch.optim.Adam(fused.parameters(), lr=1e-3)
    adam = []
    for seed in range(ADAM_STEPS):
        opt.zero_grad()
        with bench_context(settings):
            loss = fused.neg_mll(x, y, generator=torch.Generator().manual_seed(10 + seed))
        loss.backward()
        opt.step()
        adam.append(float(loss.detach()))
    say(f"  three Adam steps: losses {adam}")
    if not all(math.isfinite(v) for v in adam):
        fail("a DKL Adam step gave a non-finite loss")
    # the posterior (one solve of [y | k_*^T], K1) and LOVE serving
    with bench_context(settings), settings.verbose_linalg(True), torch.no_grad():
        c.reset_counts()
        (mean, var), post_s = _timed(torch, lambda: fused.posterior(x, y, x64))
        post = c.counts()
    say(f"  posterior at m={M_STAR}: {post_s * 1e3:.3f} ms, launches {post}")
    if post["K1"] == 0 or not (torch.isfinite(mean).all() and bool((var >= 0).all())):
        fail("the DKL posterior did not launch K1 or is not finite")
    c.launches["K1"] += post["K1"]
    c.launches["K3"] += post["K3"]
    widths = []
    love = [settings.max_cholesky_size(0), settings.max_cg_iterations(100), settings.cg_tolerance(1.0),
            settings.preconditioner_mode("auto"), settings.max_root_decomposition_size(LOVE_K),
            settings.verbose_linalg(True), torch.no_grad(),
            recording(c.rbf, "_launch_matvec_sym", lambda a, w, spec: widths.append(w.shape[-1]))]
    with contextlib.ExitStack() as stack:
        for ctx in love:
            stack.enter_context(ctx)
        c.reset_counts()
        c.log.clear()
        cache, cache_s = _timed(torch, lambda: fused.posterior_cache(x, y, generator=torch.Generator().manual_seed(2)))
        built, iters = c.counts(), list(c.log.counts)
        c.reset_counts()
        (qmean, qvar), query_s = _timed(torch, lambda: fused.posterior_from_cache(x, cache, xq))
        served = c.counts()
    say(f"  posterior_cache: {cache_s * 1e3:.3f} ms, CG iterations {iters}, Lanczos steps "
        f"{cache.root_inv.shape[-1]}, launches {built}, K3 widths {sorted(set(widths))}; posterior_from_cache at "
        f"{M_QUERY} queries {query_s * 1e3:.3f} ms, launches {served}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if built != dict(K1=0, K3=sum(iters) + cache.root_inv.shape[-1], K2=0, K4=0, K5=0) or set(widths) != {1}:
        fail("the DKL cache did not make one K3 launch at t = 1 per CG iteration and per Lanczos step")
    if served != dict(K1=2, K3=0, K2=0, K4=0, K5=0):
        fail("a DKL query from the cache did not make two K1 launches and nothing else")
    if not (torch.isfinite(qmean).all() and bool((qvar >= 0).all())):
        fail("the DKL queries are not finite")
    c.launches["K3"] += built["K3"]
    c.launches["K1"] += served["K1"]
    del fused, opt, cache, x, y
    torch.cuda.empty_cache()


PHASES = ("woodbury", "kron_toeplitz", "ski", "indexing", "fantasy", "harness", "kernel_family", "sgpr", "svgp",
          "classification", "multitask", "dkl")


def main() -> None:
    import torch

    # optional: --only PHASE[,PHASE...] runs those module-level phases alone
    # (after the build), --package DIR takes the package from DIR (a checkout
    # of another commit), so that the phases time two commits on one card
    args, only, root = sys.argv[1:], None, ROOT
    while args:
        flag, value, args = args[0], args[1] if len(args) > 1 else "", args[2:]
        if flag == "--only" and set(value.split(",")) <= set(PHASES):
            only = value.split(",")
        elif flag == "--package":
            root = Path(value).resolve()
        else:
            fail(f"usage: {Path(__file__).name} [--only {','.join(PHASES)}] [--package DIR]")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    if not (root / "linear_operator_tpu_torch" / "__init__.py").is_file():
        fail(f"the port package linear_operator_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(root))
    import linear_operator_tpu_torch as lo
    from linear_operator_tpu_torch import _build, settings
    from linear_operator_tpu_torch.functions._inv_quad_logdet import _stochastic_iqld
    from linear_operator_tpu_torch.functions._root_decomposition import _lanczos_root
    from linear_operator_tpu_torch.models.gp import PosteriorCache, _softplus
    from linear_operator_tpu_torch.operators import (
        DenseLinearOperator,
        KernelLinearOperator,
        rbf_covar,
        rbf_fused_closure,
        rbf_fused_matvec,
    )
    from linear_operator_tpu_torch.ops import rbf
    from linear_operator_tpu_torch.utils.cholesky import highest_matmul_precision

    # every kernel wrapper, whose .launches counts its kernel's launches
    wrappers = dict(K1=rbf.kernel_matvec, K3=rbf.kernel_matvec_sym, K2=rbf.kernel_weighted,
                    K4=rbf.rbf_build_sym_tiles, K5=rbf.rbf_matvec_sym_cached)

    def reset_counts():
        rbf.reset_launch_counts()

    def counts():
        return {key: w.launches for key, w in wrappers.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    times = _build.build()
    say(f"build: {time.perf_counter() - t0:.1f} s wall, " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name in _build.sources():
        if times[name]:
            say(f"  {name}: {_build.ptxas_summary(_build.library_path(name).with_suffix('.log').read_text())}")
    for name, mangled in _build.MAIN_PATH_KERNELS.items():
        log_path = _build.library_path(name).with_suffix(".log")
        if log_path.is_file():
            say(f"  {name} main-path instantiation: {_build.ptxas_report(log_path.read_text(), mangled)}")

    if only:
        if not Path(lo.__file__).resolve().is_relative_to(root):
            fail(f"the package came from {lo.__file__}, not from {root}")
        log = SolverLog()
        logging.getLogger("linear_operator_tpu_torch").setLevel(logging.DEBUG)
        logging.getLogger("linear_operator_tpu_torch").addHandler(log)
        ctx = types.SimpleNamespace(torch=torch, lo=lo, settings=settings, rbf=rbf, dev=dev, counts=counts,
                                    reset_counts=reset_counts, log=log, launches={key: 0 for key in wrappers})
        say(f"package: {root}")
        for name in only:
            globals()[f"phase_{name}"](ctx)
        return

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def check_kernel(label, got, want, rtol=KERNEL_RTOL):
        """|kernel - plain| <= rtol * max|plain|.  Both are f32 sums of up to
        n terms in different orders (~sqrt(n) eps relative); the d > 8
        quadratic form adds an order-dependent rounding near d2 = 0."""
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = math.isfinite(err) and err <= rtol * scale
        say(f"  {label}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, rel {err / scale:.2e}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label}: kernel disagrees with its plain version")
        return err

    def check_tiles(label, got, want, chunk=256):
        """K4's tiles: at most one bf16 ulp from the plain version's, and at
        least 99.9% bit-identical (the kernel's ex2.approx and torch.exp
        differ by a few f32 ulps, which now and then crosses a bf16 rounding
        boundary).  Compared in chunks of tile pairs; returns the largest
        absolute difference."""
        torch.cuda.synchronize()
        ulp, same, err = 0, 0, 0.0
        for s in range(0, got.shape[0], chunk):
            a, b = got[s : s + chunk], want[s : s + chunk]
            diff = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
            ulp = max(ulp, int(diff.max()))
            same += int((diff == 0).sum())
            err = max(err, float((a.float() - b.float()).abs().max()))
        share = same / got.numel()
        ok = got.shape == want.shape and ulp <= 1 and share >= 0.999
        say(f"  {label}: max {ulp} bf16 ulp, {100 * share:.4f}% bit-identical, max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label}: K4 disagrees with its plain version")
        return err

    def check_weighted(label, x1, x2, g, v, covar="rbf"):
        """K2's two outputs, and the dx = 2 (ws x1 - wx) its callers assemble
        from them (a difference of large sums), against both plain versions:
        its own arithmetic (g v^T through dot_acc3) to ACC3_RTOL, full
        precision to KERNEL_RTOL.  Returns the former's dx error."""
        wx, ws = rbf.kernel_weighted(x1, x2, g, v, covar)
        dx = 2.0 * (ws[:, None] * x1 - wx)
        errs = []
        for tag, plain, rtol in (("acc3", rbf.kernel_weighted_acc3_plain, ACC3_RTOL),
                                 ("full", rbf.kernel_weighted_plain, KERNEL_RTOL)):
            pwx, pws = plain(x1, x2, g, v, covar)
            check_kernel(f"{label} W@x2 vs {tag}", wx, pwx, rtol)
            check_kernel(f"{label} rowsum(W) vs {tag}", ws, pws, rtol)
            errs.append(check_kernel(f"{label} dx vs {tag}", dx, 2.0 * (pws[:, None] * x1 - pwx), rtol))
        return errs[0]

    def check_both(label, got, x1, x2, v, covar="rbf"):
        """K1 or K3 against both plain versions: its own arithmetic to
        ACC3_RTOL, full precision to KERNEL_RTOL.  Returns the former error."""
        err = check_kernel(f"{label} vs acc3", got, rbf.kernel_matvec_acc3_plain(x1, x2, v, covar), ACC3_RTOL)
        check_kernel(f"{label} vs full", got, rbf.kernel_matvec_plain(x1, x2, v, covar))
        return err

    # 3a. every covariance, at small shapes (n not a multiple of the tiles)
    say("kernels vs plain, each covariance:")
    rq = rbf.rq_tile_covar(1.5)
    for covar in ["rbf", "matern52", "matern32", "matern12", rq]:
        for d in (3, 16):
            x = randn(8192, d) / math.sqrt(d)
            if d > 8:
                # a 1/64 grid, where the quadratic form is exact in f32:
                # elsewhere the plain versions leave a point ~1e-7 from
                # itself, which Matern-1/2 turns into ~3e-4 of its diagonal
                # entry (the kernels keep that distance exactly 0)
                x = torch.round(64 * x) / 64
            v = randn(8192, 11)
            check_both(f"K3 {covar} n=8192 d={d} t=11", rbf.kernel_matvec_sym(x, v, covar), x, x, v, covar)
            # distinct x1 and x2 (Matern-1/2's k' is singular on a coincident
            # pair); m = 5000 spans two of K2's 4096-point partial sums
            x1, x2 = randn(3000, d) / math.sqrt(d), randn(5000, d) / math.sqrt(d)
            check_weighted(f"K2 {covar} n=3000 m=5000 d={d} t=11", x1, x2, randn(3000, 11), randn(5000, 11), covar)
        x1, x2, v = randn(6000, D), randn(8192, D), randn(8192, 65)
        check_both(f"K1 {covar} n=6000 m=8192 d=3 t=65", rbf.kernel_matvec(x1, x2, v, covar), x1, x2, v, covar)
    check_weighted("K2 rbf n=3000 m=5000 d=3 t=65 (five k-steps of 16)", randn(3000, D), randn(5000, D),
                   randn(3000, 65), randn(5000, 65))

    # widths past the card's old limits, which the JAX package takes: d = 200
    # (on a 1/64 grid, where the quadratic form is exact in f32), and a batch
    # of 65537 GPs, which K1 and K3 run in two launches each (the batch is a
    # grid dimension of at most 65535)
    say("kernels past 128 dimensions and past a batch of 65535 vs plain:")
    dw = 200
    x1, x2 = (torch.round(64 * randn(n, dw) / math.sqrt(dw)) / 64 for n in (2000, 3000))
    v, g, w = randn(3000, 11), randn(2000, 11), randn(2000, 11)
    check_both(f"K1 rbf n=2000 m=3000 d={dw} t=11", rbf.kernel_matvec(x1, x2, v), x1, x2, v)
    check_both(f"K3 rbf n=2000 d={dw} t=11", rbf.kernel_matvec_sym(x1, w), x1, x1, w)
    check_weighted(f"K2 rbf n=2000 m=3000 d={dw} t=11", x1, x2, g, v)
    check_tiles(f"K4 rbf n=2000 d={dw} tile={TILE}", rbf.rbf_build_sym_tiles(x1, TILE),
                rbf.rbf_build_sym_tiles_plain(x1, TILE))
    xb, vb = randn(65537, 16, D), randn(65537, 16, 5)
    before = counts()
    check_both("K1 rbf batch=65537 n=16 t=5", rbf.kernel_matvec(xb, xb, vb), xb, xb, vb)
    check_both("K3 rbf batch=65537 n=16 t=5", rbf.kernel_matvec_sym(xb, vb), xb, xb, vb)
    split = {key: counts()[key] - before[key] for key in ("K1", "K3")}
    say(f"  batch of 65537: launches {split}")
    if split != dict(K1=2, K3=2):
        fail("a batch of 65537 did not run in two launches of K1 and of K3")
    del x1, x2, v, g, w, xb, vb

    def grads(fn, inputs, weights):
        leaves = [t.clone().requires_grad_() for t in inputs]
        return torch.autograd.grad(torch.sum(fn(*leaves) * weights), leaves)

    say("backwards (autograd through the wrappers: K2, K1, K3) vs autograd through the plain version:")
    for covar in ["rbf", "matern52"]:
        x1, x2, v, w = randn(3000, D), randn(5000, D), randn(5000, 11), randn(3000, 11)
        got = grads(lambda a, b, c: rbf.kernel_matvec(a, b, c, covar), (x1, x2, v), w)
        want = grads(lambda a, b, c: rbf.kernel_matvec_plain(a, b, c, covar), (x1, x2, v), w)
        for name, a, b in zip(("dx1", "dx2", "dv"), got, want):
            check_kernel(f"K1 backward {covar} n=3000 m=5000 d=3 t=11 {name}", a, b)
        x, v, w = randn(4000, D), randn(4000, 11), randn(4000, 11)
        got = grads(lambda a, c: rbf.kernel_matvec_sym(a, c, covar), (x, v), w)
        want = grads(lambda a, c: rbf.kernel_matvec_plain(a, a, c, covar), (x, v), w)
        for name, a, b in zip(("dx", "dv"), got, want):
            check_kernel(f"K3 backward {covar} n=4000 d=3 t=11 {name}", a, b)

    # 3b. the RBF kernels at the main path's shapes (inputs scaled by the
    # initial lengthscale softplus(0), as the model scales them), timed
    say(f"kernels vs plain at the main path's shapes (N={N}, d={D}):")
    ls = math.log(2.0) + 1e-6
    x = randn(N, D) / ls
    v11, v65, g11 = randn(N, PROBES + 1), randn(N, M_STAR + 1), randn(N, PROBES + 1)
    t11 = PROBES + 1
    stats = {}
    # K3 and K1: each entry costs its formation (distance and exponent, 3d + 1
    # f32 operations) and its products (2t for K1; 4t for K3, rows and
    # columns), which the kernels run as three bf16 passes on the tensor
    # cores.  Two bounds: all in f32 outside the tensor cores, and the
    # tensor-core bound, the larger of the formation at the f32 rate and the
    # three passes at the bf16 rate (bound_ms of the kernels line, basis
    # "tensor_core").  Beside them the exponent floor: one ex2 an entry on the
    # special-function units, 16 results per SM and clock on compute
    # capability 9.0 (CUDA C++ Programming Guide, arithmetic instructions), at
    # the card's largest SM clock.
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    exp_per_s = 16 * torch.cuda.get_device_properties(0).multi_processor_count * sm_mhz * 1e6

    def timed_matvec(label, kern, args, entries, prods, nbytes, reps=5, plain_reps=2):
        """K1 or K3 (``kern``) at a path's shapes: held against both plain
        versions on ``args`` (x1, x2, v), timed by CUDA events, beside its
        bounds (``entries`` kernel entries, ``prods`` products an entry,
        ``nbytes`` read and written once); the kernels line's numbers."""
        t = args[2].shape[-1]
        err = check_kernel(f"{label} vs full", kern(), rbf.kernel_matvec_plain(*args))
        check_kernel(f"{label} vs acc3", kern(), rbf.kernel_matvec_acc3_plain(*args), ACC3_RTOL)
        ms = cuda_ms(torch, kern, reps)
        plain_ms = cuda_ms(torch, lambda: rbf.kernel_matvec_plain(*args), plain_reps)
        form = entries * (3 * D + 1)
        f32_ms, _ = bound_ms(form + entries * prods, nbytes)
        t_form, t_mma = 1e3 * form / PEAK_F32_FLOPS, 1e3 * 3 * entries * prods / PEAK_BF16_FLOPS
        t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
        b_ms, b_by = max(t_form, t_mma, t_bytes), "operations" if max(t_form, t_mma) >= t_bytes else "bytes"
        t_exp = 1e3 * entries / exp_per_s
        say(f"  {label}: {ms:.3f} ms (plain {plain_ms:.1f} ms); f32 bound {f32_ms:.3f} ms, {100 * f32_ms / ms:.1f}% "
            f"of it; tensor-core bound {b_ms:.3f} ms by {b_by} (formation {t_form:.3f} ms, three bf16 passes "
            f"{t_mma:.3f} ms, bytes {t_bytes:.3f} ms), {100 * b_ms / ms:.1f}% of it; exponent floor {t_exp:.3f} ms "
            f"({exp_per_s:.3e} a second at {sm_mhz:.0f} MHz), {100 * max(b_ms, t_exp) / ms:.1f}% of the larger "
            f"(t = {t})")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # K3 reads x and v and writes y; K1 reads x1, x2 and v and writes y
    for key, t, kern, args, entries, prods, nbytes in [
        ("K3", t11, lambda: rbf.kernel_matvec_sym(x, v11), (x, x, v11), N * (N + 1) / 2, 4 * t11,
         4 * (N * D + 2 * N * t11)),
        ("K1", M_STAR + 1, lambda: rbf.kernel_matvec(x, x, v65), (x, x, v65), N * N, 2 * (M_STAR + 1),
         4 * (2 * N * D + 2 * N * (M_STAR + 1))),
    ]:
        stats[key] = dict(timed_matvec(f"{key} rbf n={N} d={D} t={t}", kern, args, entries, prods, nbytes),
                          bound_basis="tensor_core")
    # K3's operator is symmetric: u^T (K w) = w^T (K u), with u and w exact
    # in bf16 (their lo parts are 0) and nonnegative (no cancelling sums)
    u, w = (randn(N, 1).abs().to(torch.bfloat16).float() for _ in range(2))
    kw, ku = (rbf.kernel_matvec_sym(x, a) for a in (w, u))
    ukw, wku = float((u.double() * kw.double()).sum()), float((w.double() * ku.double()).sum())
    asym = abs(ukw - wku) / abs(ukw)
    say(f"  K3 symmetry n={N}: u^T(Kw) {ukw:.8e}, w^T(Ku) {wku:.8e}, relative difference {asym:.2e}")
    if not asym <= 1e-5:
        fail("K3 is not symmetric")
    del u, w, kw, ku
    # K2 as the training step calls it, K2(x, x, g, v): per pair d2 (3d),
    # k' (2), g.v (2t), w (1), w x2 (2d), rowsum (1); reads x twice, g and
    # v, writes W@x2 and rowsum(W).  The f32 bound takes every operation at
    # the f32 rate; the tensor-core bound (bound_ms, basis "tensor_core") the
    # larger of the formation and reductions (5d + 4 a pair) at the f32 rate
    # and g.v's three bf16 passes at the bf16 rate; beside them the exponent
    # floor, one ex2 a pair
    err = check_weighted(f"K2 rbf n={N} d={D} t={t11}", x, x, g11, v11)
    kern = lambda: rbf.kernel_weighted(x, x, g11, v11)  # noqa: E731
    pairs, nbytes = N * N, 4 * (3 * N * D + 2 * N * t11 + N)
    f32_ms, _ = bound_ms(pairs * (5 * D + 2 * t11 + 4), nbytes)
    t_form, t_mma = 1e3 * pairs * (5 * D + 4) / PEAK_F32_FLOPS, 1e3 * 3 * pairs * 2 * t11 / PEAK_BF16_FLOPS
    t_bytes, t_exp = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * pairs / exp_per_s
    b_ms, b_by = max(t_form, t_mma, t_bytes), "operations" if max(t_form, t_mma) >= t_bytes else "bytes"
    stats["K2"] = dict(max_abs_err=err, ms=cuda_ms(torch, kern, 5),
                       plain_ms=cuda_ms(torch, lambda: rbf.kernel_weighted_plain(x, x, g11, v11), 2),
                       bound_ms=b_ms, bound_by=b_by, bound_basis="tensor_core")
    s2 = stats["K2"]
    say(f"  K2: {s2['ms']:.3f} ms (plain {s2['plain_ms']:.1f} ms); f32 bound {f32_ms:.3f} ms, "
        f"{100 * f32_ms / s2['ms']:.1f}% of it; tensor-core bound {b_ms:.3f} ms by {b_by} (formation and "
        f"reductions {t_form:.3f} ms, three bf16 passes {t_mma:.3f} ms), {100 * b_ms / s2['ms']:.1f}% of it; "
        f"exponent floor {t_exp:.3f} ms, {100 * max(b_ms, t_exp) / s2['ms']:.1f}% of the larger")
    # K2 at t = 201, the width of the posterior backward at m = 200: two
    # launches, of 128 and 73 columns, whose sums add
    g201, v201 = randn(N, 201), randn(N, 201)
    k2 = rbf.kernel_weighted.launches
    check_weighted(f"K2 rbf n={N} d={D} t=201", x, x, g201, v201)
    if rbf.kernel_weighted.launches - k2 != 2:
        fail("K2 at t = 201 did not run as two launches")
    say(f"  K2 at t=201 (two launches, 128 + 73 columns): "
        f"{cuda_ms(torch, lambda: rbf.kernel_weighted(x, x, g201, v201), 3):.3f} ms")
    del x, v11, v65, g11, g201, v201

    # 3c. the bf16 tile cache
    say("tile cache (K4, K5) vs plain, each covariance (K5 on K4's own tiles):")
    for covar in ["rbf", "matern52", "matern32", "matern12", rq]:
        for d in (3, 16):
            for n, tile in ((3000, 1024), (1000, 128)):
                x = randn(n, d) / math.sqrt(d)
                tiles = rbf.rbf_build_sym_tiles(x, tile, covar)
                check_tiles(f"K4 {covar} n={n} d={d} tile={tile}", tiles,
                            rbf.rbf_build_sym_tiles_plain(x, tile, covar))
                worst = 0.0
                for t in (1, 11, 16):
                    v = randn(n, t)
                    for passes in (1, 2):
                        got = rbf.rbf_matvec_sym_cached(tiles, v, n, tile, passes)
                        want = rbf.rbf_matvec_sym_cached_plain(tiles, v, n, tile, passes)
                        torch.cuda.synchronize()
                        rel = float((got - want).abs().max()) / float(want.abs().max())
                        if not rel <= KERNEL_RTOL:
                            check_kernel(f"K5 {covar} n={n} d={d} tile={tile} t={t} passes={passes}", got, want)
                        worst = max(worst, rel)
                say(f"  K5 {covar} n={n} d={d} tile={tile}: t in (1, 11, 16), passes 1 and 2, "
                    f"largest rel err {worst:.2e} ok")

    say(f"tile cache at the path's shapes (N={N}, d={D}, tile {TILE}):")
    x = randn(N, D) / ls
    tiles = rbf.rbf_build_sym_tiles(x, TILE)
    npairs = tiles.shape[0]
    cache_bytes = tiles.numel() * 2
    want = rbf.rbf_build_sym_tiles_plain(x, TILE)
    err4 = check_tiles(f"K4 rbf n={N} d={D} ({npairs} tile pairs, {tiles.numel():.3e} entries)", tiles, want)
    del want
    torch.cuda.empty_cache()
    # K4 writes the cache once and reads x; ~12 f32 operations an entry
    # (d2 by differences 3d, the exponent 2, exp ~4, the bf16 rounding 1)
    b_ms, b_by = bound_ms(12 * tiles.numel(), cache_bytes + 4 * N * D)
    stats["K4"] = dict(max_abs_err=err4, ms=cuda_ms(torch, lambda: rbf.rbf_build_sym_tiles(x, TILE), 5),
                       plain_ms=once_ms(torch, lambda: rbf.rbf_build_sym_tiles_plain(x, TILE)),
                       bound_ms=b_ms, bound_by=b_by, bound_basis="f32")
    torch.cuda.empty_cache()
    # a reference for K4's byte bound: a write-only pass over a tensor of the
    # cache's size by a PyTorch fill, the rate the card writes these bytes at
    sink = torch.empty_like(tiles)
    stats["K4"]["write_only_ms"] = cuda_ms(torch, lambda: sink.fill_(0), 5)
    del sink
    torch.cuda.empty_cache()
    # K5 reads the cache once, v once and writes y once; its products,
    # npad^2 t multiply-adds per bf16 pass, run on the tensor cores.  Timed at
    # t = 11 (the cached step's CG) and t = 1 (a cached solve's)
    npad = -(-N // TILE) * TILE
    k5 = {}
    for t in (t11, 1):
        v = randn(N, t)
        err5 = check_kernel(f"K5 rbf n={N} t={t} passes=2", rbf.rbf_matvec_sym_cached(tiles, v, N, TILE),
                            rbf.rbf_matvec_sym_cached_plain(tiles, v, N, TILE))
        b_ms, b_by = bound_ms(2 * npad * npad * t * 2, cache_bytes + 8 * N * t, PEAK_BF16_FLOPS)
        k5[t] = dict(max_abs_err=err5, ms=cuda_ms(torch, lambda: rbf.rbf_matvec_sym_cached(tiles, v, N, TILE), 5),
                     plain_ms=once_ms(torch, lambda: rbf.rbf_matvec_sym_cached_plain(tiles, v, N, TILE)),
                     bound_ms=b_ms, bound_by=b_by)
    stats["K5"] = dict(k5[t11], bound_basis="tensor_core", ms_t1=k5[1]["ms"], bound_ms_t1=k5[1]["bound_ms"])
    for key in ("K4", "K5"):
        s = stats[key]
        say(f"  {key}: {s['ms']:.3f} ms (plain {s['plain_ms']:.1f} ms, bound {s['bound_ms']:.3f} ms by "
            f"{s['bound_by']}, {100 * s['bound_ms'] / s['ms']:.1f}% of bound)")
    wo = stats["K4"]["write_only_ms"]
    say(f"  write-only pass over a tensor of the cache's size (fill_, {cache_bytes / 1e9:.3f} GB): {wo:.3f} ms, "
        f"{cache_bytes / wo / 1e9:.3f} TB/s ({100 * cache_bytes / wo / 1e9 / (PEAK_BYTES_PER_S / 1e12):.1f}% of "
        f"{PEAK_BYTES_PER_S / 1e12:.2f}); K4 writes {cache_bytes / stats['K4']['ms'] / 1e9:.3f} TB/s, "
        f"{100 * wo / stats['K4']['ms']:.1f}% of the write-only rate")
    say(f"  K5 at t=1: {k5[1]['ms']:.3f} ms (plain {k5[1]['plain_ms']:.1f} ms, bound {k5[1]['bound_ms']:.3f} ms by "
        f"{k5[1]['bound_by']}, {100 * k5[1]['bound_ms'] / k5[1]['ms']:.1f}% of bound)")
    # a reference for the byte bound: one read-only pass over the cache by a
    # PyTorch reduction, the rate the card streams these bytes at
    amax_ms = cuda_ms(torch, lambda: torch.amax(tiles.view(torch.int32)), 3)
    say(f"  read-only pass over the cache (torch.amax, {cache_bytes / 1e9:.3f} GB): {amax_ms:.3f} ms, "
        f"{cache_bytes / amax_ms / 1e9:.3f} TB/s ({100 * cache_bytes / amax_ms / 1e9 / (PEAK_BYTES_PER_S / 1e12):.1f}% "
        f"of {PEAK_BYTES_PER_S / 1e12:.2f}); K5 at t=11 streams {cache_bytes / stats['K5']['ms'] / 1e9:.3f} TB/s, "
        f"at t=1 {cache_bytes / k5[1]['ms'] / 1e9:.3f} TB/s")
    # the cached operator is symmetric: u^T (M w) = w^T (M u), with u and w
    # exact in bf16, so that the lo pass adds nothing, and nonnegative, so
    # that neither side is a cancelling sum
    u, w = (randn(N, 1).abs().to(torch.bfloat16).float() for _ in range(2))
    mw, mu = (rbf.rbf_matvec_sym_cached(tiles, a, N, TILE) for a in (w, u))
    umw, wmu = float((u.double() * mw.double()).sum()), float((w.double() * mu.double()).sum())
    asym = abs(umw - wmu) / abs(umw)
    say(f"  K5 symmetry n={N}: u^T(Mw) {umw:.8e}, w^T(Mu) {wmu:.8e}, relative difference {asym:.2e}")
    if not asym <= 1e-5:
        fail("K5 is not symmetric")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del x, tiles, v, u, w, mw, mu
    torch.cuda.empty_cache()

    def bench_settings():
        return bench_context(settings)

    # 4. a small MLL against the CPU run of the same model on the same probes
    # (the CPU run takes the kernels' plain versions)
    xs = torch.randn(2000, D, generator=torch.Generator().manual_seed(3))
    ys = torch.sin(3.0 * xs[:, 0])
    vals = []
    for device in (dev, torch.device("cpu")):
        model = lo.ExactGPRegression(materialize_threshold=None, device=device)
        with bench_settings(), torch.no_grad():
            vals.append(float(model.neg_mll(xs.to(device), ys.to(device),
                                            generator=torch.Generator().manual_seed(4))))
    rel = abs(vals[0] - vals[1]) / abs(vals[1])
    say(f"small MLL n=2000: card {vals[0]:.8f}, cpu {vals[1]:.8f}, rel {rel:.2e}")
    if not rel <= PATH_RTOL:
        fail("the small MLL on the card disagrees with the CPU run")

    # 5. the main path
    kg = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(N, D, device=dev, generator=kg)
    y = torch.sin(3.0 * x[:, 0]) + 0.1 * torch.randn(N, device=dev, generator=kg)
    x_star = torch.randn(M_STAR, D, device=dev, generator=kg)
    fused = lo.ExactGPRegression(block_rows=8192)
    plain = lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False)
    cg = SolverLog()
    log = logging.getLogger("linear_operator_tpu_torch")
    log.setLevel(logging.DEBUG)
    log.addHandler(cg)

    def neg_mll(model):
        with bench_settings(), settings.verbose_linalg(True), torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.neg_mll(x, y, generator=torch.Generator().manual_seed(1))
            val = float(out)
            return val, time.perf_counter() - t0

    def posterior(model):
        with bench_settings(), settings.verbose_linalg(True), torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = model.posterior(x, y, x_star)
            torch.cuda.synchronize()
            return mean, var, time.perf_counter() - t0

    launches = {}
    reset_counts()
    cg.counts.clear()
    mll, mll_s = neg_mll(fused)
    launches["K3"], launches["K1"] = rbf.kernel_matvec_sym.launches, rbf.kernel_matvec.launches
    mll_iters = list(cg.counts)
    say(f"neg_mll N={N} d={D}: {mll:.8f} in {mll_s:.3f} s, CG iterations {mll_iters}, "
        f"K3 launches {launches['K3']}, K1 launches {launches['K1']}")
    if not math.isfinite(mll):
        fail("neg_mll is not finite")
    if launches["K3"] != sum(mll_iters) or launches["K3"] == 0 or launches["K1"] != 0:
        fail("neg_mll did not run one K3 launch per CG iteration")

    reset_counts()
    cg.counts.clear()
    mean, var, post_s = posterior(fused)
    post = dict(K1=rbf.kernel_matvec.launches, K3=rbf.kernel_matvec_sym.launches)
    launches["K1"] += post["K1"]
    launches["K3"] += post["K3"]
    say(f"posterior N={N} m={M_STAR}: {post_s:.3f} s, CG iterations {cg.counts}, "
        f"K1 launches {post['K1']}, K3 launches {post['K3']}")
    if mean.shape != (M_STAR,) or var.shape != (M_STAR,):
        fail(f"posterior shapes {tuple(mean.shape)}, {tuple(var.shape)}")
    if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
        fail("posterior mean or variance is not finite")
    if post["K1"] != sum(cg.counts) or post["K1"] == 0:
        fail("the posterior did not run one K1 launch per CG iteration")

    # the warm second run times the path without first-call set-up
    mll2, mll2_s = neg_mll(fused)
    _, _, post2_s = posterior(fused)
    say(f"warm: neg_mll {mll2_s:.3f} s, posterior {post2_s:.3f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if mll2 != mll:
        say(f"  note: repeated neg_mll differs by {abs(mll2 - mll):.2e} (atomic summation order in K3)")
    # kernel time on the path: its launches times its time per launch at
    # the same shapes (phase 3b), as a share of the warm wall time
    for label, key, n_launch, wall in [("neg_mll", "K3", launches["K3"], mll2_s),
                                       ("posterior", "K1", post["K1"], post2_s)]:
        k_s = n_launch * stats[key]["ms"] / 1e3
        say(f"  {label}: {key} {n_launch} x {stats[key]['ms']:.3f} ms = {k_s:.3f} s, "
            f"{100 * k_s / wall:.1f}% of the warm wall time")

    # the plain path on the card, on the same probes
    cg.counts.clear()
    mll_plain, mll_plain_s = neg_mll(plain)
    rel = abs(mll - mll_plain) / abs(mll_plain)
    say(f"plain neg_mll: {mll_plain:.8f} in {mll_plain_s:.3f} s, CG iterations {cg.counts}, rel diff {rel:.2e}")
    if not rel <= PATH_RTOL:
        fail("neg_mll disagrees with the plain path")
    mean_p, var_p, post_plain_s = posterior(plain)
    rel_mean = float((mean - mean_p).abs().max() / mean_p.abs().max())
    # var = k_ss - k_*^T K^{-1} k_*, a difference of nearly equal terms: its
    # error is measured against the prior variance k_ss it is taken from
    with torch.no_grad():
        prior_var = float(fused.covariance(x_star).diagonal().max())
    rel_var = float((var - var_p).abs().max()) / prior_var
    say(f"plain posterior: {post_plain_s:.3f} s, rel diff mean {rel_mean:.2e}, "
        f"var {rel_var:.2e} of the prior variance {prior_var:.4f} "
        f"({float((var - var_p).abs().max() / var_p.abs().max()):.2e} of max var)")
    if not (rel_mean <= PATH_RTOL and rel_var <= PATH_RTOL):
        fail("the posterior disagrees with the plain path")
    # the plain path in f64: how far each f32 path is from exact arithmetic
    ref = lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False, dtype=torch.float64)
    with bench_settings(), torch.no_grad():
        mean_r, var_r = ref.posterior(x.double(), y.double(), x_star.double())
    for label, (mu, sd) in [("fused f32", (mean, var)), ("plain f32", (mean_p, var_p))]:
        e_mean = float((mu.double() - mean_r).abs().max() / mean_r.abs().max())
        e_var = float((sd.double() - var_r).abs().max()) / prior_var
        say(f"  {label} posterior vs f64 plain: mean {e_mean:.2e}, var {e_var:.2e} of the prior variance")
    del ref, mean_r, var_r

    # 5b. the repaired default: neg_mll under the default settings, whose
    # preconditioner is the rank-15 pivoted Cholesky, except that CG replaces
    # the Cholesky path at every size
    def default_terms(model, dtype=torch.float32, *overrides):
        """inv_quad_logdet of the model's training operator under the default
        settings (and ``overrides``), the two terms neg_mll sums, per data
        point."""
        cg.counts.clear()
        with settings.max_cholesky_size(0), settings.verbose_linalg(True), torch.no_grad(), \
                contextlib.ExitStack() as more:
            for c in overrides:
                more.enter_context(c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iq, ld = lo.inv_quad_logdet(model.train_operator(x.to(dtype)), y.to(dtype)[:, None], logdet=True,
                                        generator=torch.Generator().manual_seed(1))
            iq, ld = float(iq) / N, float(ld) / N
            return dict(iq=iq, ld=ld, loss=0.5 * (iq + ld + math.log(2.0 * math.pi)),
                        s=time.perf_counter() - t0, iters=list(cg.counts))

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rank = fused.train_operator(x)._build_precond_factor().shape[-1]
        torch.cuda.synchronize()
        factor_ms = 1e3 * (time.perf_counter() - t0)
    reset_counts()
    cg.counts.clear()
    with settings.max_cholesky_size(0), settings.verbose_linalg(True), torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mll_d = float(fused.neg_mll(x, y, generator=torch.Generator().manual_seed(1)))
        mll_d_s = time.perf_counter() - t0
    dflt, dflt_iters = counts(), list(cg.counts)
    say(f"default settings (preconditioner_mode {settings.preconditioner_mode.value()!r}, rank {rank}): "
        f"pivoted factor {factor_ms:.1f} ms; neg_mll {mll_d:.8f} in {mll_d_s:.3f} s, CG iterations {dflt_iters}, "
        f"launches {dflt}")
    if settings.preconditioner_mode.value() != "pivoted" or rank != 15:
        fail("the default preconditioner is not the rank-15 pivoted Cholesky")
    if not math.isfinite(mll_d) or dflt["K3"] != sum(dflt_iters) or dflt["K3"] == 0:
        fail("the default-settings neg_mll did not run one K3 launch per CG iteration")
    launches["K3"] += dflt["K3"]

    def set_noise(model, noise):
        """The model with softplus(raw_noise) + 1e-6 = noise."""
        with torch.no_grad():
            model.raw_noise.fill_(math.log(math.expm1(noise - 1e-6)))
        return model

    def show(label, r, ref=None):
        diff = "" if ref is None else f", loss rel diff {abs(r['loss'] - ref['loss']) / abs(ref['loss']):.2e}"
        say(f"  {label}: iq/n {r['iq']:.8f}, logdet/n {r['ld']:.8f}, loss {r['loss']:.8f} in {r['s']:.3f} s, "
            f"CG iterations {r['iters']}{diff}")

    # reported: the fused path again (K3's atomics sum in another order), the
    # plain path, and the plain path in f64.  At the model's initial noise
    # (0.127) the rank-15 preconditioner leaves the 20 Lanczos steps behind
    # the SLQ logdet ill-conditioned: f32 summation order alone moves the
    # logdet by ~5e-4 of itself on either path, and neg_mll = 0.5 (iq +
    # logdet) + 0.919 with logdet ~ -2 magnifies that ~40x, so no two f32
    # paths agree to PATH_RTOL there
    paths = [("fused", fused, torch.float32), ("plain", plain, torch.float32),
             ("plain f64", lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False, dtype=torch.float64),
              torch.float64)]
    runs = {label: default_terms(model, dtype) for label, model, dtype in paths}
    for label, r in runs.items():
        show(f"noise 0.127, {label} (reported)", r, None if label == "fused" else runs["fused"])

    def distances(tag, runs):
        """How far the f32 paths lie from the f64 one and from each other: in
        the loss (relative to the f64 loss) and in each of its two terms
        (relative to the f64 term)."""
        ref = runs["plain f64"]
        for a, b in (("fused", "plain f64"), ("plain", "plain f64"), ("fused", "plain")):
            rel = {k: abs(runs[a][k] - runs[b][k]) / abs(ref[k]) for k in ("loss", "iq", "ld")}
            say(f"  {tag}, {a} to {b}: loss {rel['loss']:.3e}, iq/n {rel['iq']:.3e}, logdet/n {rel['ld']:.3e} "
                f"of the f64 value")

    # the witness: the distances as run, then with CG run to 1e-2 (at most
    # 250 iterations).  The logdet comes from the probes' first 20 Lanczos
    # steps whatever the tolerance; the solve behind iq converges
    distances("noise 0.127, cg_tolerance 1.0", runs)
    tighter = {label: default_terms(model, dtype, settings.cg_tolerance(1e-2), settings.max_cg_iterations(250))
               for label, model, dtype in paths}
    for label, r in tighter.items():
        show(f"noise 0.127, cg_tolerance 1e-2, {label} (reported)", r, None if label == "fused" else tighter["fused"])
    distances("noise 0.127, cg_tolerance 1e-2", tighter)
    del paths
    # held: the same settings at noise 1.0, where CG and Lanczos are
    # well-conditioned and the two paths must agree
    held = {label: default_terms(set_noise(lo.ExactGPRegression(block_rows=8192, use_fused_kernels=use), 1.0))
            for label, use in (("fused", True), ("plain", False))}
    for label, r in held.items():
        show(f"noise 1.0, {label}", r, None if label == "fused" else held["fused"])
    rel = abs(held["fused"]["loss"] - held["plain"]["loss"]) / abs(held["plain"]["loss"])
    if not rel <= PATH_RTOL:
        fail("the default-settings neg_mll disagrees with the plain path")

    # 6. the training step: neg_mll(...).backward(), forward and backward
    # timed apart, with the launches of each half
    raw = ("raw_lengthscale", "raw_outputscale", "raw_noise")

    def train_step(model, seed, *overrides, loss_fn=None):
        """One step of ``loss_fn(model, generator)`` (default: the model's
        neg_mll on the main path's data) under the benchmark's settings."""
        model.zero_grad(set_to_none=True)
        reset_counts()
        cg.counts.clear()
        with bench_settings(), settings.verbose_linalg(True), contextlib.ExitStack() as more:
            for c in overrides:
                more.enter_context(c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = torch.Generator().manual_seed(seed)
            loss = model.neg_mll(x, y, generator=gen) if loss_fn is None else loss_fn(model, gen)
            val = float(loss.detach())
            t1 = time.perf_counter()
            fwd, fwd_iters = counts(), list(cg.counts)
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        bwd = {k: v - fwd[k] for k, v in counts().items()}
        grad = torch.stack([getattr(model, name).grad for name in raw]).double()
        return dict(loss=val, grad=grad, fwd_s=t1 - t0, bwd_s=t2 - t1, fwd=fwd, bwd=bwd,
                    fwd_iters=fwd_iters, bwd_iters=cg.counts[len(fwd_iters):])

    steps = {}
    for label in ("cold", "warm"):
        st = steps[label] = train_step(fused, 1)
        say(f"training step ({label}) N={N} d={D}: loss {st['loss']:.8f}, forward {st['fwd_s']:.3f} s "
            f"(CG iterations {st['fwd_iters']}, launches {st['fwd']}), backward {st['bwd_s']:.3f} s "
            f"(CG iterations {st['bwd_iters']}, launches {st['bwd']}), grad {st['grad'].tolist()}")
        if not (math.isfinite(st["loss"]) and torch.isfinite(st["grad"]).all()):
            fail("the training step's loss or gradients are not finite")
        if st["fwd"] != dict(K1=0, K3=sum(st["fwd_iters"]), K2=0, K4=0, K5=0) or st["fwd"]["K3"] == 0:
            fail("the training step's forward did not run one K3 launch per CG iteration and nothing else")
        # the backward reuses the forward's solves (no CG) and makes one
        # _bilinear_derivative: K2 twice for the x-gradient of K3, and K3 once,
        # the bilinear form's own mat-vec, which carries the outputscale
        # gradient; its right vectors are constants, so no K3 for dv
        if st["bwd_iters"] or st["bwd"] != dict(K1=0, K3=1, K2=2, K4=0, K5=0):
            fail("the training step's backward did not make exactly two K2 launches and one K3 launch")
    launches["K3"] += steps["cold"]["fwd"]["K3"] + steps["cold"]["bwd"]["K3"]
    launches["K2"] = steps["cold"]["bwd"]["K2"]
    warm = steps["warm"]
    k2_s = warm["bwd"]["K2"] * stats["K2"]["ms"] / 1e3
    say(f"  backward: K2 {warm['bwd']['K2']} x {stats['K2']['ms']:.3f} ms = {k2_s:.3f} s, "
        f"{100 * k2_s / warm['bwd_s']:.1f}% of the warm backward; K3 {warm['bwd']['K3']} x "
        f"{stats['K3']['ms']:.3f} ms; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the plain path on the card, on the same probes: at the benchmark's
    # settings, and with CG run to 1e-4, where the f32 CG noise of the two
    # paths is gone and each gradient, the lengthscale's through K2 included,
    # can be held to PATH_RTOL of itself
    st = train_step(plain, 1)
    err = float(torch.linalg.norm(warm["grad"] - st["grad"]) / torch.linalg.norm(st["grad"]))
    say(f"plain training step: loss {st['loss']:.8f}, forward {st['fwd_s']:.3f} s, backward {st['bwd_s']:.3f} s, "
        f"grad {st['grad'].tolist()}, |fused - plain| / |plain| = {err:.2e}")
    if not err <= PATH_RTOL:
        fail("the training step's gradients disagree with the plain path")
    tight = {label: train_step(model, 1, settings.cg_tolerance(1e-4), settings.max_cg_iterations(1000))
             for label, model in (("fused", fused), ("plain", plain))}
    rel = ((tight["fused"]["grad"] - tight["plain"]["grad"]).abs() / tight["plain"]["grad"].abs()).tolist()
    say(f"  CG to 1e-4 (iterations fused {tight['fused']['fwd_iters']}, plain {tight['plain']['fwd_iters']}): "
        f"fused grad {tight['fused']['grad'].tolist()}, plain {tight['plain']['grad'].tolist()}, "
        f"relative difference of each {rel}")
    if not max(rel) <= PATH_RTOL:
        fail("the converged training step's gradients disagree with the plain path")

    # the device's busy share over one warm fused step, from a profiler trace
    # of its kernels (CUPTI); the profiler's own overhead lengthens the step
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            st = train_step(fused, 1)
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_s = sum(e.time_range.elapsed_us() for e in kern) / 1e6
        wall = st["fwd_s"] + st["bwd_s"]
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        say(f"  profiled fused step: {wall:.3f} s wall, device busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%), "
            f"{len(kern)} device events; top: " + "; ".join(f"{name[:60]} {ms:.1f} ms" for name, ms in top))
    except Exception as exc:  # CUPTI tracing may be unavailable; no check rests on it
        say(f"  device busy share: not measured ({type(exc).__name__}: {exc})")

    # three Adam steps on the fused model, each with fresh probes
    opt = torch.optim.Adam(fused.parameters(), lr=0.05)
    start = torch.stack([getattr(fused, name).detach().clone() for name in raw])
    for k in range(3):
        st = train_step(fused, 100 + k)
        opt.step()
        now = torch.stack([getattr(fused, name).detach() for name in raw])
        say(f"  Adam step {k}: loss {st['loss']:.8f}, (raw_lengthscale, raw_outputscale, raw_noise) "
            f"{now.tolist()}, step {st['fwd_s'] + st['bwd_s']:.3f} s")
        if not (math.isfinite(st["loss"]) and torch.isfinite(now).all()):
            fail("an Adam step gave a non-finite loss or parameter")
    if not bool((now != start).all()):
        fail("the Adam steps did not move every parameter")

    # 6b. the posterior backward at m = 200 query points: the solve's 201
    # columns go to K1; its backward solves with the transpose (CG without a
    # preconditioner, as in the JAX package), makes the bilinear form's own
    # K1 mat-vec, and K1's backward makes two K2 calls of 201 columns, each
    # two launches (128 + 73 columns)
    x_200 = torch.randn(200, D, device=dev, generator=torch.Generator(device=dev).manual_seed(11))
    chunks = []
    launch_weighted = rbf._launch_weighted

    def record_chunk(a, b, gg, w, spec):
        chunks.append(gg.shape[-1])
        return launch_weighted(a, b, gg, w, spec)

    def posterior_step(model, n, *overrides, dtype=torch.float32):
        """The gradient of sum(mean) + sum(var) of the posterior on the first
        n training points (cast to ``dtype``), under the benchmark's settings
        (and ``overrides``), with its forward and backward apart; the widths
        of K2's launches recorded."""
        model.zero_grad(set_to_none=True)
        reset_counts()
        cg.counts.clear()
        chunks.clear()
        rbf._launch_weighted = record_chunk
        try:
            with bench_settings(), settings.verbose_linalg(True), contextlib.ExitStack() as more:
                for c in overrides:
                    more.enter_context(c)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mean, var = model.posterior(x[:n].to(dtype), y[:n].to(dtype), x_200.to(dtype))
                loss = mean.sum() + var.sum()
                val = float(loss.detach())
                t1 = time.perf_counter()
                fwd, fwd_iters = counts(), list(cg.counts)
                loss.backward()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
        finally:
            rbf._launch_weighted = launch_weighted
        bwd = {k: v - fwd[k] for k, v in counts().items()}
        grad = torch.stack([getattr(model, name).grad for name in raw]).double()
        return dict(loss=val, grad=grad, fwd_s=t1 - t0, bwd_s=t2 - t1, fwd=fwd, bwd=bwd, fwd_iters=fwd_iters,
                    bwd_iters=cg.counts[len(fwd_iters):], chunks=list(chunks))

    for label in ("cold", "warm"):
        st = posterior_step(fused, N)
        say(f"posterior backward ({label}) N={N} m=200: sum(mean) + sum(var) {st['loss']:.6f}, forward "
            f"{st['fwd_s']:.3f} s (CG iterations {st['fwd_iters']}, launches {st['fwd']}), backward {st['bwd_s']:.3f} s "
            f"(CG iterations {st['bwd_iters']}, launches {st['bwd']}, K2 launch widths {st['chunks']}), "
            f"grad {st['grad'].tolist()}")
        if not (math.isfinite(st["loss"]) and torch.isfinite(st["grad"]).all()):
            fail("the posterior backward's value or gradient is not finite")
        if st["fwd"]["K1"] != sum(st["fwd_iters"]) or st["fwd"]["K2"] != 0:
            fail("the posterior forward did not run one K1 launch per CG iteration")
        if st["bwd"]["K2"] != 4 or st["chunks"] != [128, 73, 128, 73]:
            fail("the posterior backward did not make two K2 calls of 201 columns, two launches each")
        if label == "cold":
            launches["K1"] += st["fwd"]["K1"] + st["bwd"]["K1"]
            launches["K2"] += st["bwd"]["K2"]
    # against the full-precision plain path on the same inputs, fresh models
    # without the dense cache, with CG run to 1e-5, at N = 20,000 (the plain
    # K1 at 201 columns would take minutes at N = 1e5), and against the exact
    # gradient, the plain path in f64 through a Cholesky solve.  At noise 1.0
    # the fused path is held to the plain one and may lie no further from the
    # exact gradient than the plain f32 path does, plus PATH_RTOL.  At the
    # model's noise 0.127 the conditioning of K + 0.127 I carries K1's three
    # bf16 products (~1e-5 of a mat-vec, the TPU kernels' _dot_acc3) into the
    # gradient at ~5e-3, far above the plain f32 path's distance: so there
    # the fused path runs twice more, with K1's launches replaced by its
    # full-precision plain version (K2's chunked launches kept), which is
    # held as the fused path is at noise 1.0, and by its plain version in the
    # kernel's own arithmetic (kernel_matvec_acc3_plain), reported
    n_held = 20_000

    @contextlib.contextmanager
    def k1_as(plain_k1):
        """K1's launches replaced by a plain version on the card."""
        launch = rbf._launch_matvec
        rbf._launch_matvec = lambda a, b, w, spec: plain_k1(a, b, w)
        try:
            yield
        finally:
            rbf._launch_matvec = launch

    def fused_step(noise, *overrides):
        model = set_noise(lo.ExactGPRegression(block_rows=8192, materialize_threshold=None), noise)
        return posterior_step(model, n_held, settings.cg_tolerance(1e-5), settings.max_cg_iterations(1000),
                              *overrides)

    for noise in (1.0, 0.127):
        fused_st = fused_step(noise)
        plain_st = posterior_step(
            set_noise(lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False, materialize_threshold=None),
                      noise),
            n_held, settings.cg_tolerance(1e-5), settings.max_cg_iterations(1000))
        exact = posterior_step(
            set_noise(lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False, materialize_threshold=None,
                                           dtype=torch.float64), noise),
            n_held, settings.max_cholesky_size(n_held), dtype=torch.float64)
        fg, pg, eg = fused_st["grad"], plain_st["grad"], exact["grad"]

        def dist(g, ref=eg):
            return float(torch.linalg.norm(g - ref) / torch.linalg.norm(ref))

        err, err_f, err_p = dist(fg, pg), dist(fg), dist(pg)
        say(f"  N={n_held} (not N={N}: the plain path's cost), noise {noise}, CG to 1e-5: fused grad {fg.tolist()} "
            f"(CG iterations {fused_st['fwd_iters']} + {fused_st['bwd_iters']}, "
            f"{fused_st['fwd_s'] + fused_st['bwd_s']:.3f} s), plain {pg.tolist()} (CG iterations "
            f"{plain_st['fwd_iters']} + {plain_st['bwd_iters']}, {plain_st['fwd_s'] + plain_st['bwd_s']:.3f} s), "
            f"exact (f64 Cholesky, {exact['fwd_s'] + exact['bwd_s']:.3f} s) {eg.tolist()}: |fused - plain| / |plain| "
            f"= {err:.2e}, |fused - exact| / |exact| = {err_f:.2e}, |plain - exact| / |exact| = {err_p:.2e} "
            f"({'held' if noise == 1.0 else 'reported'})")
        if noise == 1.0 and not (err <= PATH_RTOL and err_f <= err_p + PATH_RTOL):
            fail("the posterior backward's gradient disagrees with the plain path or the exact one")
        if noise == 1.0:
            continue
        k1_full = fused_step(noise, k1_as(rbf.kernel_matvec_plain))
        k1_acc3 = fused_step(noise, k1_as(rbf.kernel_matvec_acc3_plain))
        if k1_full["chunks"] != [128, 73, 128, 73]:
            fail("the posterior backward with a plain K1 did not make two K2 calls of 201 columns")
        err_k2 = dist(k1_full["grad"])
        say(f"    K1 in full precision, K2's chunked launches kept: grad {k1_full['grad'].tolist()}, |. - exact| / "
            f"|exact| = {err_k2:.2e} (held); K1 as kernel_matvec_acc3_plain: grad {k1_acc3['grad'].tolist()}, "
            f"|. - exact| / |exact| = {dist(k1_acc3['grad']):.2e}, |. - fused| / |fused| = "
            f"{dist(k1_acc3['grad'], fg):.2e} (reported)")
        if not err_k2 <= err_p + PATH_RTOL:
            fail("with K1 in full precision, the posterior backward's gradient lies further from the exact one "
                 "than the plain path's")
    del x_200, fused_st, plain_st, exact, k1_full, k1_acc3

    # 8. the tile-cache path at noise 1.0: bf16(K) + D stays positive definite
    # only where the noise exceeds |bf16(K) - K|_2 (indefinite at n = 1e5 and
    # the default noise 0.127), so the path runs on noisy targets
    del fused, plain, opt
    torch.cuda.empty_cache()
    y = torch.sin(3.0 * x[:, 0]) + math.sqrt(CACHE_NOISE) * torch.randn(N, device=dev, generator=kg)
    model = set_noise(lo.ExactGPRegression(block_rows=8192), CACHE_NOISE)

    def cached_operator(model, closure_impl, matvec_impl=rbf_fused_matvec):
        """The slice's entry point: the model's kernel operator with a
        per-solve closure builder, plus its noise."""
        params = {"lengthscale": _softplus(model.raw_lengthscale),
                  "outputscale": _softplus(model.raw_outputscale)}
        return KernelLinearOperator(
            x, x, params, covar_func=rbf_covar, block_rows=8192, symmetric=True,
            matvec_impl=matvec_impl, matvec_closure_impl=closure_impl,
        ).add_diagonal(_softplus(model.raw_noise))

    def cached_loss(closure_impl, matvec_impl=rbf_fused_matvec):
        def loss_fn(model, gen):
            K = cached_operator(model, closure_impl, matvec_impl)
            iq, ld = lo.inv_quad_logdet(K, y[:, None], logdet=True, generator=gen)
            return 0.5 * (iq + ld + N * math.log(2.0 * math.pi)) / N

        return loss_fn

    def plain_closure(x1, x2, params, symmetric):
        """rbf_fused_closure with the plain versions of K4 and K5."""
        xs = (x1 / params["lengthscale"]).to(torch.float32).detach().contiguous()
        tiles = rbf.rbf_build_sym_tiles_plain(xs, TILE)

        def closure(rhs):
            out = rbf.rbf_matvec_sym_cached_plain(tiles, rhs.to(torch.float32).contiguous(), N, TILE)
            return (params["outputscale"] * out).to(rhs.dtype)

        return closure

    # (a) |bf16(K) - K|_2: 15 power iterations of v -> K5 v - K3 v, scaled
    with torch.no_grad():
        ls8, os8 = (float(_softplus(getattr(model, name))) for name in ("raw_lengthscale", "raw_outputscale"))
        xs = (x / ls8).contiguous()
        tiles = rbf.rbf_build_sym_tiles(xs, TILE)
        v = randn(N, 1)
        v /= torch.linalg.norm(v)
        for _ in range(15):
            e = os8 * (rbf.rbf_matvec_sym_cached(tiles, v, N, TILE) - rbf.kernel_matvec_sym(xs, v))
            pert = float(torch.linalg.norm(e))
            v = e / pert
        del tiles, xs, v, e
        torch.cuda.empty_cache()
    say(f"tile-cache path N={N} d={D}: |bf16(K) - K|_2 = {pert:.4f} (15 power iterations), beside the noise "
        f"{CACHE_NOISE} ({pert / CACHE_NOISE:.3f} of it) and the default noise 0.127 ({pert / 0.127:.3f} of it)")
    if not pert < CACHE_NOISE / 2:
        fail("|bf16(K) - K|_2 is not below half the noise: the cache's regime is wrong")

    # (b) the training step on the cache, cold and warm
    torch.cuda.reset_peak_memory_stats()
    cached = {}
    for label in ("cold", "warm"):
        st = cached[label] = train_step(model, 1, loss_fn=cached_loss(rbf_fused_closure))
        say(f"  cached training step ({label}): loss {st['loss']:.8f}, forward {st['fwd_s']:.3f} s "
            f"(CG iterations {st['fwd_iters']}, launches {st['fwd']}), backward {st['bwd_s']:.3f} s "
            f"(CG iterations {st['bwd_iters']}, launches {st['bwd']}), grad {st['grad'].tolist()}")
        if not (math.isfinite(st["loss"]) and torch.isfinite(st["grad"]).all()):
            fail("the cached training step's loss or gradients are not finite")
        if st["fwd"] != dict(K1=0, K3=0, K2=0, K4=1, K5=sum(st["fwd_iters"])) or st["fwd"]["K5"] == 0:
            fail("the cached forward did not run one K4 launch, one K5 launch per CG iteration and nothing else")
        if st["bwd_iters"] or st["bwd"] != dict(K1=0, K3=1, K2=2, K4=0, K5=0):
            fail("the cached backward did not make exactly two K2 launches and one K3 launch")
    launches["K4"], launches["K5"] = cached["cold"]["fwd"]["K4"], cached["cold"]["fwd"]["K5"]
    warm = cached["warm"]
    k_s = stats["K4"]["ms"] / 1e3 + warm["fwd"]["K5"] * stats["K5"]["ms"] / 1e3
    say(f"  cached forward: K4 1 x {stats['K4']['ms']:.3f} ms + K5 {warm['fwd']['K5']} x {stats['K5']['ms']:.3f} ms "
        f"= {k_s:.3f} s, {100 * k_s / warm['fwd_s']:.1f}% of the warm forward; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # (c) the same step with the plain versions of K4 and K5 and the blocked
    # backward, on the same probes
    st = train_step(model, 1, loss_fn=cached_loss(plain_closure, None))
    rel = abs(st["loss"] - warm["loss"]) / abs(st["loss"])
    err = float(torch.linalg.norm(warm["grad"] - st["grad"]) / torch.linalg.norm(st["grad"]))
    say(f"  plain cached step: loss {st['loss']:.8f} (rel diff {rel:.2e}), forward {st['fwd_s']:.3f} s "
        f"(CG iterations {st['fwd_iters']}), backward {st['bwd_s']:.3f} s, grad {st['grad'].tolist()} "
        f"(|cached - plain| / |plain| = {err:.2e}), launches {counts()}")
    if not (rel <= PATH_RTOL and err <= PATH_RTOL):
        fail("the cached training step disagrees with its plain versions")
    if any(counts().values()):
        fail("the plain cached step launched a kernel")

    # (d) the same step on the f32 K3 path: what bf16(K) costs
    st = train_step(model, 1, loss_fn=cached_loss(None))
    rel = abs(warm["loss"] - st["loss"]) / abs(st["loss"])
    err = float(torch.linalg.norm(warm["grad"] - st["grad"]) / torch.linalg.norm(st["grad"]))
    say(f"  f32 K3 step: loss {st['loss']:.8f}, forward {st['fwd_s']:.3f} s (CG iterations {st['fwd_iters']}), "
        f"grad {st['grad'].tolist()}; bf16(K) moves the loss by {rel:.2e} and the gradient by {err:.2e} "
        f"of its norm (reported, not held)")
    torch.cuda.empty_cache()

    # (e) a solve under the default settings (pivoted rank 15) to 1e-4, its
    # residual taken on the cached operator itself
    with settings.max_cholesky_size(0), settings.cg_tolerance(1e-4), settings.verbose_linalg(True), \
            torch.no_grad():
        reset_counts()
        cg.counts.clear()
        K = cached_operator(model, rbf_fused_closure)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = lo.solve(K, y[:, None])
        torch.cuda.synchronize()
        solve_s, solve_counts, solve_iters = time.perf_counter() - t0, counts(), list(cg.counts)
        apply = rbf_fused_closure(x, x, K._linear_op.params, True)
        resid = float(torch.linalg.norm(apply(sol) + K._diag_op._diagonal()[:, None] * sol - y[:, None])
                      / torch.linalg.norm(y))
        del K, apply
    k_s = stats["K4"]["ms"] / 1e3 + solve_counts["K5"] * stats["K5"]["ms_t1"] / 1e3
    say(f"  default-settings solve, cg_tolerance 1e-4: {solve_s:.3f} s, CG iterations {solve_iters} "
        f"(of at most {settings.max_cg_iterations.value()}), launches {solve_counts}, "
        f"|(bf16(K) + noise I) x - y| / |y| = {resid:.2e}; K4 1 x {stats['K4']['ms']:.3f} ms + K5 "
        f"{solve_counts['K5']} x {stats['K5']['ms_t1']:.3f} ms (t=1) = {k_s:.3f} s, {100 * k_s / solve_s:.1f}% of it")
    if not (torch.isfinite(sol).all() and resid <= 1e-3):
        fail("the default-settings solve on the cache missed its 1e-3 residual")
    if not (solve_iters and max(solve_iters) < settings.max_cg_iterations.value()):
        fail("CG did not converge before max_cg_iterations")
    if solve_counts["K4"] != 1 or solve_counts["K5"] != sum(solve_iters):
        fail("the solve did not run one K4 launch and one K5 launch per CG iteration")

    # (f) three Adam steps on the cached path, each with fresh probes
    opt = torch.optim.Adam(model.parameters(), lr=0.05)
    start = torch.stack([getattr(model, name).detach().clone() for name in raw])
    for k in range(3):
        st = train_step(model, 100 + k, loss_fn=cached_loss(rbf_fused_closure))
        opt.step()
        now = torch.stack([getattr(model, name).detach() for name in raw])
        say(f"  cached Adam step {k}: loss {st['loss']:.8f}, (raw_lengthscale, raw_outputscale, raw_noise) "
            f"{now.tolist()}, step {st['fwd_s'] + st['bwd_s']:.3f} s")
        if not (math.isfinite(st["loss"]) and torch.isfinite(now).all()):
            fail("a cached Adam step gave a non-finite loss or parameter")
    if not bool((now != start).all()):
        fail("the cached Adam steps did not move every parameter")

    # 9. LOVE serving, the JAX benchmark's config 3d (bench.py:383-423): the
    # cache (one CG solve for alpha = K^{-1} y, LOVE_K Lanczos steps for an
    # inverse root R with R R^T ~= K^{-1}) built once, each batch of M_LOVE
    # queries then served by two K1 launches and no solve
    del model, opt
    torch.cuda.empty_cache()
    lg = torch.Generator(device=dev).manual_seed(20)
    xl = torch.randn(N, D, device=dev, generator=lg)
    yl = torch.sin(3.0 * xl[:, 0]) + 0.1 * torch.randn(N, device=dev, generator=lg)
    xq = torch.randn(M_LOVE, D, device=dev, generator=lg)

    def love_settings(*overrides):
        """bench.py's settings for the LOVE cache (bench.py:400-403)."""
        stack = contextlib.ExitStack()
        for c in [settings.max_cholesky_size(0), settings.max_cg_iterations(100), settings.cg_tolerance(1.0),
                  settings.preconditioner_mode("auto"), settings.max_root_decomposition_size(LOVE_K),
                  settings.verbose_linalg(True), torch.no_grad(), *overrides]:
            stack.enter_context(c)
        return stack

    def build_cache(model, xx, yy):
        """The model's LOVE cache from a seeded generator: the cache, seconds,
        launches and CG iterations."""
        reset_counts()
        cg.counts.clear()
        with love_settings():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = model.posterior_cache(xx, yy, generator=torch.Generator().manual_seed(2))
            torch.cuda.synchronize()
            return cache, time.perf_counter() - t0, counts(), list(cg.counts)

    def serve(model, xx, cache, xs):
        """One batch of queries from the cache: mean, variance, seconds,
        launches and CG iterations."""
        reset_counts()
        cg.counts.clear()
        with love_settings():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = model.posterior_from_cache(xx, cache, xs)
            torch.cuda.synchronize()
            return mean, var, time.perf_counter() - t0, counts(), list(cg.counts)

    love = lo.ExactGPRegression(block_rows=8192)
    builds = {}
    for label in ("cold", "warm"):
        cache, build_s, cnt, iters = build_cache(love, xl, yl)
        builds[label] = dict(s=build_s, K3=cnt["K3"])
        say(f"LOVE cache ({label}) N={N} d={D}: {build_s:.3f} s, CG iterations {iters}, Lanczos steps "
            f"{cache.root_inv.shape[-1]}, launches {cnt}")
        if not (torch.isfinite(cache.alpha).all() and torch.isfinite(cache.root_inv).all()):
            fail("the LOVE cache is not finite")
        if not iters or cache.root_inv.shape != (N, LOVE_K) or cnt != dict(K1=0, K3=sum(iters) + LOVE_K, K2=0, K4=0,
                                                                          K5=0):
            fail("the LOVE cache did not make one K3 launch per CG iteration and per Lanczos step, and nothing else")
        if label == "cold":
            launches["K3"] += cnt["K3"]
    with torch.no_grad():
        prior_q = love.covariance(xq).diagonal()
    served = [serve(love, xl, cache, xq) for _ in range(1 + LOVE_REPS)]
    mean_l, var_l = served[0][:2]
    for mean, var, _, cnt, iters in served:
        if cnt != dict(K1=2, K3=0, K2=0, K4=0, K5=0) or iters:
            fail(f"a LOVE query made launches {cnt} and CG iterations {iters}, not two K1 launches and no CG")
        if mean.shape != (M_LOVE,) or var.shape != (M_LOVE,):
            fail(f"LOVE query shapes {tuple(mean.shape)}, {tuple(var.shape)}")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
            fail("a LOVE query's mean or variance is not finite")
        if not bool(((var >= 0) & (var <= prior_q)).all()):
            fail("a LOVE variance lies outside [0, the prior variance]")
    launches["K1"] += served[0][3]["K1"]
    warm_q = [q[2] for q in served[1:]]
    query_s = statistics.median(warm_q)
    say(f"LOVE query N={N} m={M_LOVE}: cold {served[0][2] * 1e3:.3f} ms, warm median {query_s * 1e3:.3f} ms "
        f"(of {len(warm_q)}: {', '.join(f'{q * 1e3:.3f}' for q in warm_q)}), {M_LOVE / query_s:.1f} points/s; "
        f"launches {served[0][3]}, CG iterations {served[0][4]}")
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, q_s, _, _ = serve(love, xl, cache, xq)
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        dev_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        say(f"  profiled query: {q_s * 1e3:.3f} ms wall, device kernels {dev_ms:.3f} ms "
            f"({100 * dev_ms / (q_s * 1e3):.1f}%), {len(kern)} device events; top: "
            + "; ".join(f"{name[:50]} {ms:.3f} ms" for name, ms in top))
    except Exception as exc:  # CUPTI tracing may be unavailable; no check rests on it
        say(f"  query kernel time by profiler: not measured ({type(exc).__name__}: {exc})")

    # the uncached posterior at the same m: one CG over the 1 + m columns
    # [y | k_*^T] through K1 at every iteration
    post_s = {}
    for label in ("cold", "warm"):
        reset_counts()
        cg.counts.clear()
        with love_settings():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean_p, var_p = love.posterior(xl, yl, xq)
            torch.cuda.synchronize()
            post_s[label] = time.perf_counter() - t0
        say(f"uncached posterior ({label}) N={N} m={M_LOVE}: {post_s[label]:.3f} s, CG iterations {cg.counts}, "
            f"launches {counts()}")
        if not (torch.isfinite(mean_p).all() and torch.isfinite(var_p).all()):
            fail("the uncached posterior at m = M_LOVE is not finite")
    d_mean = float((mean_l - mean_p).abs().max() / mean_p.abs().max())
    d_var = float((var_l - var_p).abs().max() / prior_q.max())
    say(f"  serving: warm posterior {post_s['warm']:.3f} s / warm LOVE query {query_s * 1e3:.3f} ms = "
        f"{post_s['warm'] / query_s:.1f}x; the cache's warm build {builds['warm']['s']:.3f} s is "
        f"{builds['warm']['s'] / post_s['warm']:.2f} uncached calls.  LOVE (k = {LOVE_K}) against the CG posterior "
        f"(reported, not held: the rank-{LOVE_K} approximation): mean {d_mean:.3e} of max|mean|, variance "
        f"{d_var:.3e} of the prior variance")

    # the kernels at the LOVE shapes: K3 at t = 1 (the alpha solve's CG and
    # the Lanczos steps), K1 on the 1024 x 1e5 cross-covariance at t = 1 and
    # t = LOVE_K
    say(f"kernels at the LOVE shapes (N={N}, m={M_LOVE}, d={D}):")
    xs_l, xq_l = (xl / ls).contiguous(), (xq / ls).contiguous()
    v1, vk = randn(N, 1), randn(N, LOVE_K)
    k3 = timed_matvec(f"K3 rbf n={N} d={D} t=1", lambda: rbf.kernel_matvec_sym(xs_l, v1), (xs_l, xs_l, v1),
                      N * (N + 1) / 2, 4, 4 * (N * D + 2 * N), reps=20, plain_reps=1)
    stats["K3"].update(ms_t1=k3["ms"], plain_ms_t1=k3["plain_ms"], bound_ms_t1=k3["bound_ms"],
                       max_abs_err_t1=k3["max_abs_err"])
    for t, v in ((1, v1), (LOVE_K, vk)):
        k1 = timed_matvec(f"K1 rbf n={M_LOVE} m={N} d={D} t={t}", lambda: rbf.kernel_matvec(xq_l, xs_l, v),
                          (xq_l, xs_l, v), M_LOVE * N, 2 * t, 4 * ((M_LOVE + N) * D + (N + M_LOVE) * t),
                          reps=20, plain_reps=2)
        stats["K1"].update({f"ms_love_t{t}": k1["ms"], f"plain_ms_love_t{t}": k1["plain_ms"],
                            f"bound_ms_love_t{t}": k1["bound_ms"], f"max_abs_err_love_t{t}": k1["max_abs_err"]})
    q_kernels = stats["K1"]["ms_love_t1"] + stats["K1"][f"ms_love_t{LOVE_K}"]
    say(f"  a query's two K1 launches: {q_kernels:.3f} ms by CUDA events, {100 * q_kernels / (query_s * 1e3):.1f}% "
        f"of its warm wall time; a warm build's K3 launches at t=1: {builds['warm']['K3']} x {k3['ms']:.3f} ms = "
        f"{builds['warm']['K3'] * k3['ms'] / 1e3:.3f} s of {builds['warm']['s']:.3f} s")
    del xs_l, xq_l, v1, vk, cache

    # the fused LOVE path against the plain (blocked) one at N_LOVE_HELD, one
    # generator seed for both, at the model's initial noise and at noise 1.0.
    # The witness of each f32 path's distance from exact arithmetic is the
    # plain path in f64 on the same start vector: the f32 draw of that seed,
    # which posterior_cache makes in the operator's dtype, widened to f64 and
    # passed to root_inv_decomposition
    xh, yh = xl[:N_LOVE_HELD], yl[:N_LOVE_HELD]
    start = torch.randn((N_LOVE_HELD,), generator=torch.Generator().manual_seed(2)).to(dev)

    def love_at(use_fused, noise, dtype=torch.float32):
        model = lo.ExactGPRegression(block_rows=8192, use_fused_kernels=use_fused, dtype=dtype)
        if noise is not None:
            set_noise(model, noise)
        if dtype == torch.float32:
            c, s, _, c_iters = build_cache(model, xh, yh)
        else:
            cg.counts.clear()
            with love_settings():
                K = model.train_operator(xh.to(dtype)).with_preconditioner()
                root_inv = K.root_inv_decomposition(initial_vectors=start.to(dtype)[:, None]).root.to_dense()
                c = PosteriorCache(alpha=lo.solve(K, yh.to(dtype)[:, None]), root_inv=root_inv)
            s, c_iters = float("nan"), list(cg.counts)
        mu, sd, _, _, _ = serve(model, xh.to(dtype), c, xq.to(dtype))
        with torch.no_grad():
            prior = float(model.covariance(xq.to(dtype)).diagonal().max())
        return dict(mean=mu.double(), var=sd.double(), s=s, iters=c_iters, prior=prior)

    for noise in (None, 1.0):
        tag = "noise 0.127 (the model's initial)" if noise is None else f"noise {noise}"
        runs = {label: love_at(use, noise, dtype) for label, use, dtype in
                (("fused", True, torch.float32), ("plain", False, torch.float32),
                 ("plain f64", False, torch.float64))}

        def dist(a, b):
            return (float((runs[a]["mean"] - runs[b]["mean"]).abs().max() / runs[b]["mean"].abs().max()),
                    float((runs[a]["var"] - runs[b]["var"]).abs().max()) / runs[b]["prior"])

        for a, b in (("fused", "plain"), ("fused", "plain f64"), ("plain", "plain f64")):
            dm, dv = dist(a, b)
            say(f"  LOVE N={N_LOVE_HELD} m={M_LOVE}, {tag}: {a} to {b}: mean {dm:.3e} of max|mean|, variance "
                f"{dv:.3e} of the prior variance ({a}: build {runs[a]['s']:.3f} s, CG iterations {runs[a]['iters']})")
        dm, dv = dist("fused", "plain")
        if not (dm <= PATH_RTOL and dv <= PATH_RTOL):
            fail(f"the fused LOVE path disagrees with the plain path at N={N_LOVE_HELD}, {tag}")
        # reported: how far the rank-LOVE_K variance and the uncached CG
        # posterior's (the benchmark's settings) lie from the exact posterior
        # (f64, Cholesky)
        exact_model = lo.ExactGPRegression(block_rows=8192, use_fused_kernels=False, dtype=torch.float64)
        cg_model = lo.ExactGPRegression(block_rows=8192)
        for m_ in (exact_model, cg_model):
            if noise is not None:
                set_noise(m_, noise)
        with love_settings(settings.max_cholesky_size(N_LOVE_HELD)):
            _, var_x = exact_model.posterior(xh.double(), yh.double(), xq.double())
        with love_settings():
            _, var_cg = cg_model.posterior(xh, yh, xq)
        prior = runs["fused"]["prior"]
        say(f"  LOVE N={N_LOVE_HELD} m={M_LOVE}, {tag}, against the exact posterior (f64, Cholesky; reported): "
            f"fused LOVE variance {float((runs['fused']['var'] - var_x).abs().max()) / prior:.3e}, the CG "
            f"posterior's {float((var_cg.double() - var_x).abs().max()) / prior:.3e} of the prior variance; "
            f"mean exact variance {float(var_x.mean()) / prior:.3e}, LOVE {float(runs['fused']['var'].mean()) / prior:.3e} "
            f"of the prior")
        del exact_model, cg_model, var_x, var_cg
        torch.cuda.empty_cache()
    del xh, yh, runs, start

    # reported: the inverse root's backward (not on the serving path), the
    # gradient of sum((b^T R)^2) with respect to the raw parameters at
    # n = N_INV_ROOT, k = LOVE_K, the model's initial noise, on one start vector:
    # the fused path twice (K3's atomics sum in another order each run), the
    # plain path, and the plain path in f64.  Its bilinear form has 4k
    # columns, which K1's backward sends to K2 twice
    xb, bb = xl[:N_INV_ROOT], torch.randn(N_INV_ROOT, device=dev, generator=lg)
    sb = torch.randn((N_INV_ROOT,), generator=torch.Generator().manual_seed(0)).to(dev)

    def inv_root_grad(use_fused, dtype=torch.float32):
        model = lo.ExactGPRegression(block_rows=8192, use_fused_kernels=use_fused, materialize_threshold=None,
                                     dtype=dtype)
        reset_counts()
        with settings.max_cholesky_size(0), settings.preconditioner_mode("auto"), \
                settings.max_root_decomposition_size(LOVE_K):
            R = model.train_operator(xb.to(dtype)).root_inv_decomposition(initial_vectors=sb.to(dtype)[:, None])
            torch.sum((bb.to(dtype) @ R.root.to_dense()) ** 2).backward()
        return torch.stack([getattr(model, name).grad for name in raw]).double(), counts()["K2"]

    (g1, k2a), (g2, _), (gp, _), (g64, _) = (inv_root_grad(True), inv_root_grad(True), inv_root_grad(False),
                                             inv_root_grad(False, torch.float64))

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    say(f"  inverse root backward n={N_INV_ROOT} k={LOVE_K} (reported): fused grad {g1.tolist()} ({k2a} K2 launches), plain "
        f"{gp.tolist()}, f64 {g64.tolist()}; |fused - fused again| {rel(g1, g2):.2e}, |fused - plain| {rel(g1, gp):.2e}, "
        f"|fused - f64| {rel(g1, g64):.2e}, |plain - f64| {rel(gp, g64):.2e} of the norm")
    # two K2 calls of 4k columns, each in chunks of at most 128 (8 launches at k = 100)
    if not (torch.isfinite(g1).all() and k2a == 2 * -(-4 * LOVE_K // 128)):
        fail("the inverse root's backward is not finite or did not make two K2 calls of 4k columns")
    del xb, bb, sb

    # 10. the JAX benchmark's config 2 (bench.py:221-238): inv_quad_logdet and
    # the root of 64 dense 1024 x 1024 SPD matrices under the default
    # settings (n > max_cholesky_size: CG + SLQ and a Lanczos root).  It runs
    # no TPU kernel: the dense products are PyTorch's
    g2 = torch.Generator(device=dev).manual_seed(30)
    a2 = torch.randn(B_DENSE, N_DENSE, N_DENSE, device=dev, generator=g2) / math.sqrt(N_DENSE)
    rhs2 = torch.randn(B_DENSE, N_DENSE, 3, device=dev, generator=g2)
    eye2 = torch.eye(N_DENSE, device=dev)
    with highest_matmul_precision():
        mats = a2 @ a2.mT + 2.0 * eye2
    del a2

    def dense_step(m, r):
        op = DenseLinearOperator(m)
        iq, ld = lo.inv_quad_logdet(op, r, logdet=True, generator=torch.Generator().manual_seed(3))
        return iq, ld, op.root_decomposition(generator=torch.Generator().manual_seed(4)).root.to_dense()

    dense_s = []
    for _ in range(1 + LOVE_REPS):
        reset_counts()
        cg.counts.clear()
        with settings.verbose_linalg(True), torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iq2, ld2, root2 = dense_step(mats, rhs2)
            torch.cuda.synchronize()
            dense_s.append(time.perf_counter() - t0)
        if any(counts().values()):
            fail("the batched dense step launched a kernel")
    warm_d = statistics.median(dense_s[1:])
    say(f"batched dense step (config 2, no TPU kernel) b={B_DENSE} n={N_DENSE}: cold {dense_s[0]:.3f} s, warm median "
        f"{warm_d:.3f} s ({B_DENSE / warm_d:.1f} matrices/s), CG iterations {cg.counts}, root {tuple(root2.shape)}")
    if not (torch.isfinite(iq2).all() and torch.isfinite(ld2).all() and torch.isfinite(root2).all()):
        fail("the batched dense step is not finite")
    # the same step in f64 on the first DENSE_HELD matrices, on the same draws
    # (the probes and the Lanczos start, redrawn from the same seeds in f32)
    with torch.no_grad():
        nprobe = settings.num_trace_samples.value()
        probes = torch.randn((B_DENSE, N_DENSE, nprobe), generator=torch.Generator().manual_seed(3))
        probes = probes[:DENSE_HELD].to(dev).double()
        norms = torch.linalg.norm(probes, dim=-2, keepdim=True)
        op64 = DenseLinearOperator(mats[:DENSE_HELD].double())
        iq64, ld64 = _stochastic_iqld(op64, rhs2[:DENSE_HELD].double(), probes / norms, probes / norms, norms)
        init = torch.randn((B_DENSE, N_DENSE), generator=torch.Generator().manual_seed(4))[:DENSE_HELD]
        root64, _ = _lanczos_root(op64, None, need_inverse=False, init=init.to(dev).double())
        gram, gram64 = (r @ r.mT for r in (root2[:DENSE_HELD].double(), root64))
        exact_ld = torch.linalg.slogdet(op64.tensor)[1]
    e_iq = float(((iq2[:DENSE_HELD].double() - iq64.sum(-1)).abs() / iq64.sum(-1).abs()).max())
    e_ld = float(((ld2[:DENSE_HELD].double() - ld64).abs() / ld64.abs()).max())
    e_root = float((gram - gram64).abs().max() / gram64.abs().max())
    say(f"  f32 against f64 on {DENSE_HELD} matrices, the same draws: inv_quad {e_iq:.3e}, logdet {e_ld:.3e}, "
        f"R R^T {e_root:.3e} (held to {PATH_RTOL}); the SLQ logdet against the exact one (reported): "
        f"{float(((ld64 - exact_ld).abs() / exact_ld.abs()).max()):.3e}")
    if not max(e_iq, e_ld, e_root) <= PATH_RTOL:
        fail("the batched dense step in f32 disagrees with the same step in f64")
    del mats, rhs2, root2, root64, gram, gram64, op64

    # 11-13. the exact Woodbury operator (config 1), CIQ sampling (config 6)
    # and the predictive distribution
    ctx = types.SimpleNamespace(
        torch=torch, lo=lo, settings=settings, rbf=rbf, dev=dev, counts=counts, reset_counts=reset_counts, log=cg,
        stats=stats, launches=launches, timed_matvec=timed_matvec, love_settings=love_settings,
    )
    phase_woodbury(ctx)
    phase_ciq(ctx)
    phase_predictive(ctx)
    # 14-15. the structured operators: config 4 (Kronecker-Toeplitz) and
    # config 4b (SKI / KISS-GP)
    phase_kron_toeplitz(ctx)
    phase_ski(ctx)
    # 16. indexing, the fantasy update and the shipped harness on the card
    phase_indexing(ctx)
    phase_fantasy(ctx)
    phase_harness(ctx)
    # 17. the rest of the kernel operator: Matern and RQ on K1-K3 at N = 1e5,
    # the blocked engine's covariances and layouts, a registered covariance
    phase_kernel_family(ctx)
    # 18. the inducing-point, classification, multitask and deep-kernel
    # models at full width
    for phase in (phase_sgpr, phase_svgp, phase_classification, phase_multitask, phase_dkl):
        phase(ctx)
    for key in ("K1", "K2", "K3"):
        stats[key]["ms_by_covar"] = {name: ms[key] for name, ms in ctx.family_ms.items()}
    stats["K3"]["ms_t1_by_covar"] = {name: ms["K3_t1"] for name, ms in ctx.family_ms.items()}

    # 7. the kernels line, then the result
    kernels = []
    for key, name, source, replaces in [
        ("K1", "kernel_matvec", "linear_operator_tpu_torch/csrc/kernel_matvec.cu",
         "linear_operator_tpu/ops/rbf.py:277"),
        ("K3", "kernel_matvec_sym", "linear_operator_tpu_torch/csrc/kernel_matvec_sym.cu",
         "linear_operator_tpu/ops/rbf.py:432"),
        ("K2", "kernel_weighted", "linear_operator_tpu_torch/csrc/kernel_weighted.cu",
         "linear_operator_tpu/ops/rbf.py:305"),
        ("K4", "rbf_build_sym_tiles", "linear_operator_tpu_torch/csrc/kernel_build_sym.cu",
         "linear_operator_tpu/ops/rbf.py:513"),
        ("K5", "rbf_matvec_sym_cached", "linear_operator_tpu_torch/csrc/kernel_matvec_cached.cu",
         "linear_operator_tpu/ops/rbf.py:585"),
    ]:
        if launches[key] == 0:
            fail(f"{name} was never launched on the main path")
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[key], **stats[key], library_ms=None))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
