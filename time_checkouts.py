"""Time the port's kernels and paths in two or more checkouts on one GPU, in turns.

    python3 time_checkouts.py [--rounds R] DIR [DIR ...]

Each DIR is the root of a checkout holding ``linear_operator_tpu_torch/``
(a commit unpacked with ``git archive``).  Round r runs one child process per
checkout, in the given order on even rounds and reversed on odd ones (A B,
B A, A B, ...), so that a drift of the card's clock falls on every checkout
alike.  A child imports the package from its DIR (building its kernels there
on its first run) and, at chip_smoke.py's main-path shapes (N = 100,000,
d = 3, RBF, bench.py's settings), times:

  - each kernel over 5 launches after one warm-up, with CUDA events: K3 at
    t = 11, K1 at t = 65, K2 at t = 11, K4 (the tile-1024 cache), K5 at
    t = 11;
  - on the host's clock, after one cold run, 3 warm runs each of ``neg_mll``,
    ``posterior`` (m = 64), and the forward and backward of the training
    step and of the tile-cache path's training step (noise 1.0).

Prints the card, one JSON line per child, then one JSON object: for each
checkout and number, the min, median and max over its runs.  Without a CUDA
device, or if a child fails, it exits 1.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, D, M_STAR, PROBES, TILE = 100_000, 3, 64, 10, 1024
REPS, WARM = 5, 3


def child(root: Path) -> dict:
    import torch

    sys.path.insert(0, str(root))
    import linear_operator_tpu_torch as lo
    from linear_operator_tpu_torch import _build, settings
    from linear_operator_tpu_torch.models.gp import _softplus
    from linear_operator_tpu_torch.operators import KernelLinearOperator, rbf_covar, rbf_fused_closure, rbf_fused_matvec
    from linear_operator_tpu_torch.ops import rbf

    assert Path(lo.__file__).resolve().is_relative_to(root.resolve()), lo.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    x = torch.randn(N, D, device=dev, generator=gen) / (math.log(2.0) + 1e-6)
    v11, v65, g11 = (torch.randn(N, t, device=dev, generator=gen) for t in (PROBES + 1, M_STAR + 1, PROBES + 1))
    out["K3_ms"] = cuda_ms(lambda: rbf.kernel_matvec_sym(x, v11))
    out["K1_ms"] = cuda_ms(lambda: rbf.kernel_matvec(x, x, v65))
    out["K2_ms"] = cuda_ms(lambda: rbf.kernel_weighted(x, x, g11, v11))
    out["K4_ms"] = cuda_ms(lambda: rbf.rbf_build_sym_tiles(x, TILE))
    tiles = rbf.rbf_build_sym_tiles(x, TILE)
    out["K5_ms"] = cuda_ms(lambda: rbf.rbf_matvec_sym_cached(tiles, v11, N, TILE))
    del x, v11, v65, g11, tiles
    torch.cuda.empty_cache()

    kg = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(N, D, device=dev, generator=kg)
    y = torch.sin(3.0 * x[:, 0]) + 0.1 * torch.randn(N, device=dev, generator=kg)
    x_star = torch.randn(M_STAR, D, device=dev, generator=kg)

    def bench_settings():
        stack = contextlib.ExitStack()
        for c in [settings.max_cholesky_size(0), settings.num_trace_samples(PROBES),
                  settings.max_cg_iterations(100), settings.cg_tolerance(1.0),
                  settings.preconditioner_mode("auto"), settings.max_lanczos_quadrature_iterations(20)]:
            stack.enter_context(c)
        return stack

    def wall(key, fn):
        """fn's wall seconds over one cold run and WARM warm runs, the warm
        ones kept; fn returns None, or the host time its forward ended."""
        for k in range(WARM + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t1 = fn()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if k:
                if t1 is None:
                    out.setdefault(f"{key}_s", []).append(t2 - t0)
                else:
                    out.setdefault(f"{key}_fwd_s", []).append(t1 - t0)
                    out.setdefault(f"{key}_bwd_s", []).append(t2 - t1)

    def step(model, loss_fn):
        model.zero_grad(set_to_none=True)
        with bench_settings():
            loss = loss_fn(model, torch.Generator().manual_seed(1))
            float(loss.detach())
            t1 = time.perf_counter()
            loss.backward()
        return t1

    fused = lo.ExactGPRegression(block_rows=8192, device=dev)
    with torch.no_grad():
        def neg_mll():
            with bench_settings():
                float(fused.neg_mll(x, y, generator=torch.Generator().manual_seed(1)))

        def posterior():
            with bench_settings():
                fused.posterior(x, y, x_star)

        wall("neg_mll", neg_mll)
        wall("posterior", posterior)
    wall("train_step", lambda: step(fused, lambda m, g: m.neg_mll(x, y, generator=g)))

    y = torch.sin(3.0 * x[:, 0]) + torch.randn(N, device=dev, generator=kg)
    cached = lo.ExactGPRegression(block_rows=8192, device=dev)
    with torch.no_grad():
        cached.raw_noise.fill_(math.log(math.expm1(1.0 - 1e-6)))

    def cached_loss(model, g):
        params = {"lengthscale": _softplus(model.raw_lengthscale), "outputscale": _softplus(model.raw_outputscale)}
        K = KernelLinearOperator(x, x, params, covar_func=rbf_covar, block_rows=8192, symmetric=True,
                                 matvec_impl=rbf_fused_matvec, matvec_closure_impl=rbf_fused_closure,
                                 ).add_diagonal(_softplus(model.raw_noise))
        iq, ld = lo.inv_quad_logdet(K, y[:, None], logdet=True, generator=g)
        return 0.5 * (iq + ld + N * math.log(2.0 * math.pi)) / N

    wall("cached_step", lambda: step(cached, cached_loss))
    return out


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        print(json.dumps(child(Path(args[1]))), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this script times the port on a GPU", file=sys.stderr, flush=True)
        sys.exit(1)
    rounds = 6
    if args[:1] == ["--rounds"]:
        rounds, args = int(args[1]), args[2:]
    dirs = [str(Path(a).resolve()) for a in args]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    runs = {d: [] for d in dirs}
    for r in range(rounds):
        for d in dirs if r % 2 == 0 else dirs[::-1]:
            proc = subprocess.run([sys.executable, __file__, "--child", d], capture_output=True, text=True)
            if proc.returncode != 0:
                print(f"FAIL: round {r}, {d}:\n{proc.stdout}\n{proc.stderr}", file=sys.stderr, flush=True)
                sys.exit(1)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[d].append(rec)
            print(json.dumps({"round": r, "dir": d, **rec}), flush=True)
    summary = {}
    for d, recs in runs.items():
        summary[d] = {}
        for key in recs[0]:
            vals = [v for rec in recs for v in (rec[key] if isinstance(rec[key], list) else [rec[key]])]
            summary[d][key] = dict(min=min(vals), median=statistics.median(vals), max=max(vals))
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
