#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (linear_operator_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
 1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
 2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
 3. hold every kernel (K1, K3, K2) against its plain PyTorch version on the
    card, for each covariance at small shapes (K1 and K3 against both plain
    versions: full precision, and kernel_matvec_acc3_plain, their own 3-pass
    bf16 arithmetic), and the backwards of K1 and K3 against autograd
    through the plain version; then each RBF kernel at the shapes of the
    main path, timed with CUDA events beside its bounds, and K3's symmetry;
    3c. the bf16 tile cache: K4 and K5 against their plain versions for each
    covariance (K5 on K4's own tiles), K5's symmetry, then both at
    N = 100,000, tile 1024, timed beside their bounds;
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
 8. the tile-cache path at N = 100,000, noise 1.0: a kernel operator with
    matvec_closure_impl=rbf_fused_closure, through inv_quad_logdet and
    solve.  (a) |bf16(K) - K|_2 by power iteration; (b) the training step
    (forward: one K4 launch, one K5 launch per CG iteration, nothing else;
    backward: two K2 launches and one K3 launch); (c) the same step with
    the plain versions of K4 and K5, held against (b); (d) the same step on
    the f32 K3 path, reported; (e) a default-settings solve to 1e-4, its
    residual on the cached operator; (f) three Adam steps;
 7. one JSON line listing every ported kernel with its launches, error,
    times and bound (bound_basis: the f32 rate, or the tensor cores' for K1,
    K3 and K5), then, as the last line, {"ok": true, "device": {...}}.

Any failed check, or any exception, exits non-zero without the last line.
Without a CUDA device, or without the package beside it, it fails at once.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import subprocess
import sys
import time
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


class CGIterations(logging.Handler):
    """Collects the iteration counts that linear_cg logs under verbose_linalg."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.counts: list[int] = []

    def emit(self, record):
        if record.msg.startswith("linear_cg finished"):
            self.counts.append(int(record.args[0]))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    if not (ROOT / "linear_operator_tpu_torch" / "__init__.py").is_file():
        fail(f"the port package linear_operator_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import linear_operator_tpu_torch as lo
    from linear_operator_tpu_torch import _build, settings
    from linear_operator_tpu_torch.models.gp import _softplus
    from linear_operator_tpu_torch.operators import (
        KernelLinearOperator,
        rbf_covar,
        rbf_fused_closure,
        rbf_fused_matvec,
    )
    from linear_operator_tpu_torch.ops import rbf

    # every kernel wrapper, whose .launches counts its kernel's launches
    wrappers = dict(K1=rbf.kernel_matvec, K3=rbf.kernel_matvec_sym, K2=rbf.kernel_weighted,
                    K4=rbf.rbf_build_sym_tiles, K5=rbf.rbf_matvec_sym_cached)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

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

    def check_weighted(label, x1, x2, g, v, covar="rbf"):
        """K2's two outputs, and the dx = 2 (ws x1 - wx) its callers assemble
        from them (a difference of large sums), against the plain version."""
        wx, ws = rbf.kernel_weighted(x1, x2, g, v, covar)
        pwx, pws = rbf.kernel_weighted_plain(x1, x2, g, v, covar)
        check_kernel(f"{label} W@x2", wx, pwx)
        check_kernel(f"{label} rowsum(W)", ws, pws)
        return check_kernel(f"{label} dx", 2.0 * (ws[:, None] * x1 - wx), 2.0 * (pws[:, None] * x1 - pwx))

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
    check_weighted("K2 rbf n=3000 m=5000 d=3 t=65 (three column chunks)", randn(3000, D), randn(5000, D),
                   randn(3000, 65), randn(5000, 65))

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
    for key, t, kern, args, entries, prods in [
        ("K3", t11, lambda: rbf.kernel_matvec_sym(x, v11), (x, x, v11), N * (N + 1) / 2, 4 * t11),
        ("K1", M_STAR + 1, lambda: rbf.kernel_matvec(x, x, v65), (x, x, v65), N * N, 2 * (M_STAR + 1)),
    ]:
        nbytes = 4 * (N * D + N * t + N * t) if key == "K3" else 4 * (2 * N * D + 2 * N * t)
        form = entries * (3 * D + 1)
        err = check_kernel(f"{key} rbf n={N} d={D} t={t} vs full", kern(), rbf.kernel_matvec_plain(*args))
        check_kernel(f"{key} rbf n={N} d={D} t={t} vs acc3", kern(), rbf.kernel_matvec_acc3_plain(*args), ACC3_RTOL)
        ms = cuda_ms(torch, kern, 5)
        plain_ms = cuda_ms(torch, lambda: rbf.kernel_matvec_plain(*args), 2)
        f32_ms, _ = bound_ms(form + entries * prods, nbytes)
        t_form, t_mma = 1e3 * form / PEAK_F32_FLOPS, 1e3 * 3 * entries * prods / PEAK_BF16_FLOPS
        t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
        b_ms, b_by = max(t_form, t_mma, t_bytes), "operations" if max(t_form, t_mma) >= t_bytes else "bytes"
        t_exp = 1e3 * entries / exp_per_s
        stats[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          bound_basis="tensor_core")
        say(f"  {key}: {ms:.3f} ms (plain {plain_ms:.1f} ms); f32 bound {f32_ms:.3f} ms, {100 * f32_ms / ms:.1f}% "
            f"of it; tensor-core bound {b_ms:.3f} ms by {b_by} (formation {t_form:.3f} ms, three bf16 passes "
            f"{t_mma:.3f} ms), {100 * b_ms / ms:.1f}% of it; exponent floor {t_exp:.3f} ms ({exp_per_s:.3e} "
            f"a second at {sm_mhz:.0f} MHz), {100 * max(b_ms, t_exp) / ms:.1f}% of the larger")
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
    # v, writes W@x2 and rowsum(W)
    err = check_weighted(f"K2 rbf n={N} d={D} t={t11}", x, x, g11, v11)
    kern = lambda: rbf.kernel_weighted(x, x, g11, v11)  # noqa: E731
    b_ms, b_by = bound_ms(N * N * (5 * D + 2 * t11 + 4), 4 * (3 * N * D + 2 * N * t11 + N))
    stats["K2"] = dict(max_abs_err=err, ms=cuda_ms(torch, kern, 5),
                       plain_ms=cuda_ms(torch, lambda: rbf.kernel_weighted_plain(x, x, g11, v11), 2),
                       bound_ms=b_ms, bound_by=b_by, bound_basis="f32")
    s2 = stats["K2"]
    say(f"  K2: {s2['ms']:.3f} ms (plain {s2['plain_ms']:.1f} ms, bound {b_ms:.3f} ms by {b_by}, "
        f"{100 * b_ms / s2['ms']:.1f}% of bound)")
    del x, v11, v65, g11

    # 3c. the bf16 tile cache
    def check_tiles(label, got, want, chunk=256):
        """K4's tiles: at most one bf16 ulp from the plain version's, and at
        least 99.9% bit-identical (expf and torch.exp may differ by an f32
        ulp, which now and then crosses a bf16 rounding boundary).  Compared
        in chunks of tile pairs; returns the largest absolute difference."""
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
    stats["K4"] = dict(max_abs_err=err4, ms=cuda_ms(torch, lambda: rbf.rbf_build_sym_tiles(x, TILE), 3),
                       plain_ms=once_ms(torch, lambda: rbf.rbf_build_sym_tiles_plain(x, TILE)),
                       bound_ms=b_ms, bound_by=b_by, bound_basis="f32")
    torch.cuda.empty_cache()
    v11 = randn(N, t11)
    err5 = check_kernel(f"K5 rbf n={N} t={t11} passes=2", rbf.rbf_matvec_sym_cached(tiles, v11, N, TILE),
                        rbf.rbf_matvec_sym_cached_plain(tiles, v11, N, TILE))
    # K5 reads the cache once, v once and writes y once; its products,
    # npad^2 t multiply-adds per bf16 pass, are what a tensor core computes
    npad = -(-N // TILE) * TILE
    b_ms, b_by = bound_ms(2 * npad * npad * t11 * 2, cache_bytes + 8 * N * t11, PEAK_BF16_FLOPS)
    stats["K5"] = dict(max_abs_err=err5, ms=cuda_ms(torch, lambda: rbf.rbf_matvec_sym_cached(tiles, v11, N, TILE), 5),
                       plain_ms=once_ms(torch, lambda: rbf.rbf_matvec_sym_cached_plain(tiles, v11, N, TILE)),
                       bound_ms=b_ms, bound_by=b_by, bound_basis="tensor_core")
    for key in ("K4", "K5"):
        s = stats[key]
        say(f"  {key}: {s['ms']:.3f} ms (plain {s['plain_ms']:.1f} ms, bound {s['bound_ms']:.3f} ms by "
            f"{s['bound_by']}, {100 * s['bound_ms'] / s['ms']:.1f}% of bound)")
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
    del x, tiles, v11, u, w, mw, mu
    torch.cuda.empty_cache()

    def bench_settings():
        """bench.py's settings for the N = 1e5 MLL (bench.py:100-129)."""
        stack = contextlib.ExitStack()
        for c in [
            settings.max_cholesky_size(0), settings.num_trace_samples(PROBES),
            settings.max_cg_iterations(100), settings.cg_tolerance(1.0),
            settings.preconditioner_mode("auto"), settings.max_lanczos_quadrature_iterations(20),
        ]:
            stack.enter_context(c)
        return stack

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
    cg = CGIterations()
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
    say(f"  default-settings solve, cg_tolerance 1e-4: {solve_s:.3f} s, CG iterations {solve_iters} "
        f"(of at most {settings.max_cg_iterations.value()}), launches {solve_counts}, "
        f"|(bf16(K) + noise I) x - y| / |y| = {resid:.2e}")
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
