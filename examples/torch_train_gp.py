"""Training the port's model families end to end with ``torch.optim``: the
exact GP (CG and SLQ), SKI / KISS-GP on a Toeplitz grid, deep kernel
learning, SGPR's collapsed bound and SVGP's minibatch bound, as
``examples/train_gp.py`` trains the JAX package's with optax.  Runs on the
card unless given ``--device cpu``:

    python examples/torch_train_gp.py [--steps 50] [--n 2000] [--device cpu]

The last line of the output is a JSON summary: each model's loss at its
first and last step and whether its predictions are finite.
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


def make_data(n: int, device, d: int = 1):
    """f32 data, the models' dtype."""
    g = torch.Generator(device=device).manual_seed(0)
    kw = dict(dtype=torch.float32, device=device, generator=g)
    x = 4.0 * torch.rand(n, d, **kw) - 2.0
    y = torch.sin(3.0 * x[:, 0]) + 0.5 * x[:, 0] ** 2 + 0.1 * torch.randn(n, **kw)
    return x, y - y.mean()


def train(model, loss_fn, steps: int, lr: float = 0.05) -> list:
    """Adam on the model's parameters: [first loss, last loss]."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))  # a host read: the step has finished
    print(f"  {steps} steps in {time.perf_counter() - t0:.2f}s: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return [losses[0], losses[-1]]


def _summary(mean, var=None) -> dict:
    out = dict(finite=bool(torch.isfinite(mean).all() and (var is None or torch.isfinite(var).all())))
    print(f"  posterior mean range [{float(mean.min()):.2f}, {float(mean.max()):.2f}]"
          + ("" if var is None else f", mean predictive sd {float(var.clamp_min(0).sqrt().mean()):.3f}"))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--grid", type=int, default=256, help="SKI's grid points")
    p.add_argument("--inducing", type=int, default=64, help="SGPR's and SVGP's inducing points")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = make_data(args.n, device)
    x_star = torch.linspace(-2.0, 2.0, 200, dtype=torch.float32, device=device)[:, None]
    out = dict(example="torch_train_gp")

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    print(f"== Exact GP (n={args.n}): CG/SLQ marginal likelihood")
    gp = lo.ExactGPRegression(device=device)
    loss = train(gp, lambda: gp.neg_mll(x, y, generator=gen()), args.steps)
    with torch.no_grad():
        out["exact"] = dict(loss=loss, **_summary(*gp.posterior(x, y, x_star)))

    print("== SKI / KISS-GP: interpolation onto a Toeplitz grid")
    ski = lo.SKIGPRegression(lo.make_grid(x, [args.grid]), device=device)
    loss = train(ski, lambda: ski.neg_mll(x, y, generator=gen()), args.steps)
    with torch.no_grad():
        out["ski"] = dict(loss=loss, **_summary(ski.posterior_mean(x, y, x_star)))

    print("== DKL: GP on learned MLP features (end-to-end gradients)")
    dkl = lo.DeepKernelGPRegression(1, (32, 16, 2), generator=torch.Generator().manual_seed(7), device=device)
    loss = train(dkl, lambda: dkl.neg_mll(x, y, generator=gen()), args.steps)
    with torch.no_grad():
        out["dkl"] = dict(loss=loss, **_summary(*dkl.posterior(x, y, x_star)))

    print(f"== SGPR: collapsed variational bound, m={args.inducing} inducing points")
    sgpr = lo.SGPRRegression(x, args.inducing, device=device)
    loss = train(sgpr, lambda: sgpr.neg_elbo(x, y), args.steps)
    with torch.no_grad():
        out["sgpr"] = dict(loss=loss, **_summary(*sgpr.posterior(x, y, x_star)))

    batch = min(256, args.n)
    print(f"== SVGP: minibatch variational bound (batch {batch}), m={args.inducing}")
    svgp = lo.SVGPRegression(x, args.inducing, device=device)
    picks = torch.Generator(device=device).manual_seed(42)

    def minibatch_loss():
        idx = torch.randperm(args.n, device=device, generator=picks)[:batch]
        return svgp.neg_elbo(x[idx], y[idx], num_data=args.n)

    loss = train(svgp, minibatch_loss, args.steps * 4)
    with torch.no_grad():
        elbo = float(svgp.elbo(x, y))
        print(f"  full-data ELBO {elbo:.1f}")
        out["svgp"] = dict(loss=loss, elbo=elbo, **_summary(*svgp.posterior(x_star)))
    out["finite"] = all(v["finite"] and all(map(math.isfinite, v["loss"])) for k, v in out.items()
                        if isinstance(v, dict))
    print("\nDone.")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
