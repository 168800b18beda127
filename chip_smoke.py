#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (linear_operator_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
 1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
 2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
 3. hold every kernel against its plain PyTorch version on the card, for each
    covariance at small shapes, and for the RBF kernel at the shapes of the
    main path, timed with CUDA events beside its bound;
 4. check a small exact-GP MLL against the CPU run of the same model;
 5. the main path, through the entry points a user calls: the exact-GP
    negative MLL at N = 100,000, d = 3 with the benchmark's settings (K3 must
    launch once per CG iteration), then the posterior at N = 100,000, m = 64
    query points (K1 must launch); each is held against the plain path on
    the card on the same probes;
 6. one JSON line listing every ported kernel with its launches, error and
    times, then, as the last line, {"ok": true, "device": {...}}.

Any failed check, or any exception, exits non-zero without the last line.
Without a CUDA device, or without the package beside it, it fails at once.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks at the full 700 W power limit (NVIDIA data sheet): f32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N, D, M_STAR, PROBES = 100_000, 3, 64, 10
KERNEL_RTOL = 1e-4  # |kernel - plain| <= KERNEL_RTOL * max|plain|, see check_kernel
# Fused vs plain path (and card vs CPU) on the same probes.  Both are f32;
# their mat-vecs differ by ~1e-7 relative, which ~20 iterations of
# preconditioned CG carry into the MLL and the posterior (~1e-5 at n = 2500);
# a wrong kernel moves them by O(1).
PATH_RTOL = 1e-3


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the flops over the
    f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ptxas_summary(log: str) -> str:
    """Most registers any kernel instantiation uses, and how many spill."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [ln for ln in log.splitlines() if "spill stores" in ln and " 0 bytes spill stores" not in ln]
    return f"{len(regs)} kernels, at most {max(regs, default=0)} registers, {len(spills)} spill"


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
    from linear_operator_tpu_torch.ops import rbf

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
            say(f"  {name}: {ptxas_summary(_build.library_path(name).with_suffix('.log').read_text())}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def check_kernel(label, got, want):
        """|kernel - plain| <= KERNEL_RTOL * max|plain|.  Both are f32 sums
        of up to n terms in different orders (~sqrt(n) eps relative); the
        d > 8 quadratic form adds an order-dependent rounding near d2 = 0."""
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = math.isfinite(err) and err <= KERNEL_RTOL * scale
        say(f"  {label}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, rel {err / scale:.2e}) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label}: kernel disagrees with its plain version")
        return err

    # 3a. every covariance, at small shapes (n not a multiple of the tiles)
    say("kernels vs plain, each covariance:")
    rq = rbf.rq_tile_covar(1.5)
    for covar in ["rbf", "matern52", "matern32", "matern12", rq]:
        for d in (3, 16):
            x = randn(8192, d) / math.sqrt(d)
            v = randn(8192, 11)
            check_kernel(f"K3 {covar} n=8192 d={d} t=11", rbf.kernel_matvec_sym(x, v, covar),
                         rbf.kernel_matvec_plain(x, x, v, covar))
        x1, x2, v = randn(6000, D), randn(8192, D), randn(8192, 65)
        check_kernel(f"K1 {covar} n=6000 m=8192 d=3 t=65", rbf.kernel_matvec(x1, x2, v, covar),
                     rbf.kernel_matvec_plain(x1, x2, v, covar))

    # 3b. the RBF kernels at the main path's shapes (inputs scaled by the
    # initial lengthscale softplus(0), as the model scales them), timed
    say(f"kernels vs plain at the main path's shapes (N={N}, d={D}):")
    ls = math.log(2.0) + 1e-6
    x = randn(N, D) / ls
    v11, v65 = randn(N, PROBES + 1), randn(N, M_STAR + 1)
    stats = {}
    for key, t, kern, plain, flops, nbytes in [
        ("K3", PROBES + 1, lambda: rbf.kernel_matvec_sym(x, v11), lambda: rbf.kernel_matvec_plain(x, x, v11),
         N * (N + 1) / 2 * (3 * D + 1 + 4 * (PROBES + 1)), 4 * N * (D + 2 * (PROBES + 1))),
        ("K1", M_STAR + 1, lambda: rbf.kernel_matvec(x, x, v65), lambda: rbf.kernel_matvec_plain(x, x, v65),
         N * N * (3 * D + 1 + 2 * (M_STAR + 1)), 4 * (2 * N * D + 2 * N * (M_STAR + 1))),
    ]:
        err = check_kernel(f"{key} rbf n={N} d={D} t={t}", kern(), plain())
        ms = cuda_ms(torch, kern, 5)
        plain_ms = cuda_ms(torch, plain, 2)
        b_ms, b_by = bound_ms(flops, nbytes)
        stats[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        say(f"  {key}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms by {b_by}, "
            f"{100 * b_ms / ms:.1f}% of bound)")
    del x, v11, v65

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
    rbf.kernel_matvec.launches = rbf.kernel_matvec_sym.launches = 0
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

    rbf.kernel_matvec.launches = rbf.kernel_matvec_sym.launches = 0
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

    # 6. the kernels line, then the result
    kernels = []
    for key, name, source, replaces in [
        ("K1", "kernel_matvec", "linear_operator_tpu_torch/csrc/kernel_matvec.cu",
         "linear_operator_tpu/ops/rbf.py:277"),
        ("K3", "kernel_matvec_sym", "linear_operator_tpu_torch/csrc/kernel_matvec_sym.cu",
         "linear_operator_tpu/ops/rbf.py:432"),
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
