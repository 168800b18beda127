"""Tour of linear_operator_tpu_torch, the PyTorch/CUDA port: the demos of
``examples/demo.py`` (structured solves, a custom operator, composition, a
GP's marginal likelihood and its gradients, structured sampling) with the
port's API.  Runs on the card unless given ``--device cpu``:

    python examples/torch_demo.py                # moderate sizes
    python examples/torch_demo.py --big          # the 10M x 10M Woodbury solve
    python examples/torch_demo.py --device cpu --woodbury-n 10000 --gp-n 256 \\
        --kron 20,10 --sample-side 8             # a small run on the CPU

Timings are taken after a first (warm-up) call, with the device synchronized
around each; the last line of the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

# python puts the SCRIPT's dir (examples/) on sys.path, not the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import linear_operator_tpu_torch as lo  # noqa: E402
from linear_operator_tpu_torch import settings  # noqa: E402


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn):
    """fn() once to warm up, then (its result, the seconds of a second call)."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def section(title: str) -> None:
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def demo_woodbury(n: int, device, rank: int = 20) -> dict:
    """A = C C^T + diag(d) solved in O(n r^2), never materialized."""
    section(f"Woodbury solve: N={n:,}, rank={rank}")
    g = torch.Generator(device=device).manual_seed(0)
    c = torch.randn(n, rank, device=device, generator=g) / math.sqrt(rank)
    d = torch.rand(n, device=device, generator=g) + 0.5
    b = torch.randn(n, device=device, generator=g)
    a = lo.LowRankRootLinearOperator(lo.DenseLinearOperator(c)).add_diagonal(d)
    print(f"operator: {type(a).__name__}, shape {a.shape}")
    x, dt = _timed(device, lambda: a.solve(b[:, None])[:, 0])
    # the normwise backward error |A x - b| / (|A| |x| + |b|): the plain
    # residual is floored at kappa(A) eps by rounding the exact solution
    ax = c @ (c.mT @ x) + d * x
    a_norm = torch.linalg.eigvalsh(c.mT @ c)[-1] + d.max()
    eta = float(torch.linalg.norm(ax - b) / (a_norm * torch.linalg.norm(x) + torch.linalg.norm(b)))
    print(f"solve: {dt * 1e3:.2f} ms warm, normwise backward error {eta:.2e}")
    return dict(solve_ms=dt * 1e3, backward_error=eta, finite=bool(torch.isfinite(x).all()))


class MyDiag(lo.LinearOperator):
    """A diagonal operator from scratch: a shape, a product and a transpose,
    and a closed-form log-determinant; everything else (solves, gradients,
    indexing) comes from the base class."""

    def __init__(self, diag: torch.Tensor):
        self.diag = diag

    def _shape(self):
        return (*self.diag.shape, self.diag.shape[-1])

    def _matmul(self, rhs):
        return self.diag[..., :, None] * rhs

    def _transpose(self):
        return self

    def logdet(self, *, generator=None):
        return torch.sum(torch.log(self.diag), dim=-1)


def demo_custom_operator(device) -> dict:
    section("Custom operator in ~15 lines")
    diag = torch.tensor([1.0, 2.0, 3.0], device=device, requires_grad=True)
    op = MyDiag(diag)
    print("matmul:", (op @ torch.tensor([4.0, 5.0, 6.0], device=device)).tolist())
    ld = op.logdet()
    ld.backward()
    print("logdet:", float(ld.detach()))
    print("grad of logdet wrt diag:", diag.grad.tolist())
    return dict(logdet=float(ld.detach()))


def demo_composite(n1: int, n2: int, device) -> dict:
    """Kronecker + Root(Toeplitz): composition keeps the structure, and the
    solve runs matrix-free CG on structured products."""
    n = n1 * n2
    section(f"Composite Kronecker + Toeplitz-root solve: N={n:,}")
    g = torch.Generator(device=device).manual_seed(1)
    m1 = torch.randn(n1, n1, device=device, generator=g)
    m1 = m1 @ m1.mT / n1 + torch.eye(n1, device=device)
    m2 = torch.randn(n2, n2, device=device, generator=g)
    m2 = m2 @ m2.mT / n2 + torch.eye(n2, device=device)
    col = torch.cat([torch.tensor([2.0], device=device), 0.5 ** torch.arange(1, n, device=device)])
    b = torch.randn(n, device=device, generator=g)
    a = lo.KroneckerProductLinearOperator(lo.DenseLinearOperator(m1), lo.DenseLinearOperator(m2)) + \
        lo.RootLinearOperator(lo.ToeplitzLinearOperator(col))
    print(f"operator: {a.shape} {type(a).__name__}")

    def solve():
        with settings.max_cholesky_size(1):  # the iterative path
            return a.solve(b[:, None])[:, 0]

    x, dt = _timed(device, solve)
    resid = float(torch.linalg.norm(a @ x - b) / torch.linalg.norm(b))
    print(f"CG solve: {dt * 1e3:.1f} ms warm, relative residual {resid:.2e}")
    return dict(solve_ms=dt * 1e3, residual=resid)


def demo_gp_mll(n: int, device, d: int = 3, steps: int = 5) -> dict:
    """The BBMM workflow: kernel operator, CG solve and SLQ log-determinant,
    gradients, and a few Adam steps on the hyperparameters."""
    section(f"GP marginal likelihood + gradients: n={n:,}")
    g = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(n, d, device=device, generator=g)
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn(n, device=device, generator=g)
    raw = {k: torch.tensor(v, device=device, requires_grad=True) for k, v in (("ls", 0.9), ("os", 1.0), ("noise", 0.1))}

    def neg_mll():
        k = lo.rbf_kernel_operator(x, lengthscale=raw["ls"], outputscale=raw["os"]).add_diagonal(raw["noise"])
        with settings.max_cholesky_size(1):
            inv_quad, logdet = k.inv_quad_logdet(y[:, None], logdet=True,
                                                 generator=torch.Generator(device=device).manual_seed(3))
        return 0.5 * (inv_quad + logdet)

    def value_and_grad():
        for p in raw.values():
            p.grad = None
        v = neg_mll()
        v.backward()
        return v

    v, dt = _timed(device, value_and_grad)
    print(f"-MLL = {float(v.detach()):.1f}  ({dt * 1e3:.1f} ms warm, forward and backward)")
    print("grads:", {k: float(p.grad) for k, p in raw.items()})
    opt = torch.optim.Adam(raw.values(), lr=0.05)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = neg_mll()
        loss.backward()
        opt.step()
        with torch.no_grad():
            for p in raw.values():
                p.clamp_(min=1e-3)
        losses.append(float(loss))
    print(f"{steps} Adam steps: -MLL {losses[0]:.1f} -> {losses[-1]:.1f}")
    return dict(loss=[losses[0], losses[-1]], ms=dt * 1e3)


def demo_sampling(n1: int, n2: int, device) -> dict:
    """Sampling a structured MVN without forming the covariance: the
    Kronecker operator's root is factor-wise."""
    n = n1 * n2
    section(f"Structured MVN sampling: N={n:,} (Kronecker covariance)")
    g = torch.Generator(device=device).manual_seed(3)
    m1 = torch.randn(n1, n1, device=device, generator=g)
    m1 = m1 @ m1.mT / n1 + 0.1 * torch.eye(n1, device=device)
    m2 = torch.randn(n2, n2, device=device, generator=g)
    m2 = m2 @ m2.mT / n2 + 0.1 * torch.eye(n2, device=device)
    cov = lo.KroneckerProductLinearOperator(lo.DenseLinearOperator(m1), lo.DenseLinearOperator(m2))
    samples = cov.zero_mean_mvn_samples(8, generator=torch.Generator(device=device).manual_seed(4))
    print(f"samples: {tuple(samples.shape)}")
    emp = torch.var(samples[:, 0])
    print(f"empirical 8-sample variance of the first coordinate {float(emp):.3f} vs exact "
          f"{float(cov.diagonal()[0]):.3f}")
    return dict(finite=bool(torch.isfinite(samples).all()))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--big", action="store_true", help="the 10M x 10M Woodbury solve")
    p.add_argument("--device", default="cuda")
    p.add_argument("--woodbury-n", type=int, default=None, help="the Woodbury solve's n (1M, or 10M with --big)")
    p.add_argument("--gp-n", type=int, default=4096)
    p.add_argument("--kron", default="200,100", help="the composite's two Kronecker factor sizes")
    p.add_argument("--sample-side", type=int, default=64)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__}, device {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    n_wood = args.woodbury_n or (10_000_000 if args.big else 1_000_000)
    n1, n2 = (int(s) for s in args.kron.split(","))
    out = dict(example="torch_demo", woodbury=demo_woodbury(n_wood, device), custom=demo_custom_operator(device),
               composite=demo_composite(n1, n2, device), gp=demo_gp_mll(args.gp_n, device),
               sampling=demo_sampling(args.sample_side, args.sample_side, device))
    out["finite"] = bool(out["woodbury"]["finite"] and out["sampling"]["finite"]
                         and all(math.isfinite(v) for v in out["gp"]["loss"]))
    print("\nAll demos done.")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
