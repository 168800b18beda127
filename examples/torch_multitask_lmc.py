"""LMC multitask GP through a multi-output ``KernelLinearOperator`` in the
PyTorch/CUDA port, as ``examples/multitask_lmc.py`` in the JAX package: a
covariance that returns a lazy operator, K_xx (x) B B^T as a
``KroneckerProductLinearOperator``, wrapped with
``num_outputs_per_input=(T, T)`` and trained by gradient descent through
the CG + SLQ marginal likelihood.  Runs on the card unless given
``--device cpu``:

    python examples/torch_multitask_lmc.py [--steps 100] [--n 256] [--device cpu]

The last line of the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

# python puts the SCRIPT's dir (examples/) on sys.path, not the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import linear_operator_tpu_torch as lo  # noqa: E402
from linear_operator_tpu_torch import settings  # noqa: E402
from linear_operator_tpu_torch.operators import rbf_covar  # noqa: E402

T = 2  # tasks


def lmc_covar(x1, x2, lengthscale, outputscale, lmc_coeffs):
    """k((x, i), (x', j)) = k_rbf(x, x') (B B^T)_ij, returned lazily."""
    k_xx = rbf_covar(x1, x2, lengthscale, outputscale)
    return lo.KroneckerProductLinearOperator(lo.DenseLinearOperator(k_xx),
                                             lo.RootLinearOperator(lo.DenseLinearOperator(lmc_coeffs)))


def make_operator(params: dict, x: torch.Tensor):
    op = lo.KernelLinearOperator(
        x, x,
        {"lengthscale": torch.nn.functional.softplus(params["raw_ls"]),
         "outputscale": torch.nn.functional.softplus(params["raw_os"]),
         "lmc_coeffs": params["lmc"]},
        covar_func=lmc_covar, num_outputs_per_input=(T, T),
        nonbatch_dims=(("lengthscale", 0), ("outputscale", 0), ("lmc_coeffs", 2)), symmetric=True,
    )
    return op.add_diagonal(torch.nn.functional.softplus(params["raw_noise"]) + 1e-4)


def neg_mll(params: dict, x: torch.Tensor, y_flat: torch.Tensor, generator) -> torch.Tensor:
    K = make_operator(params, x)  # (n T, n T)
    with settings.max_cholesky_size(0), settings.cg_tolerance(1e-2), settings.num_trace_samples(16), \
            settings.max_cg_iterations(200):
        iq, ld = K.inv_quad_logdet(y_flat[:, None], logdet=True, generator=generator)
    n_total = y_flat.shape[0]
    return 0.5 * (iq + ld + n_total * math.log(2 * math.pi)) / n_total


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(0)
    kw = dict(dtype=torch.float32, device=device)
    x = torch.randn(args.n, 2, generator=g, **kw)
    # two correlated tasks of a shared latent function
    f = torch.sin(2.0 * x[:, 0]) * torch.cos(x[:, 1])
    y = torch.stack([f, 0.7 * f + 0.2 * x[:, 0]], dim=-1)
    y = y + 0.05 * torch.randn(y.shape, generator=g, **kw)
    y_flat = y.reshape(-1)  # interleaved (point-major): Kron(K, B)

    params = {"raw_ls": torch.tensor(0.5, **kw), "raw_os": torch.tensor(0.5, **kw),
              "raw_noise": torch.tensor(-2.0, **kw), "lmc": torch.eye(T, **kw) + 0.1}
    for v in params.values():
        v.requires_grad_(True)
    lr, losses = 0.1, []
    for step in range(args.steps):
        for v in params.values():
            v.grad = None
        val = neg_mll(params, x, y_flat, torch.Generator(device=device).manual_seed(step))
        val.backward()
        with torch.no_grad():
            for v in params.values():
                v -= lr * v.grad
        losses.append(float(val.detach()))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  -MLL/n = {losses[-1]:.4f}")

    B = params["lmc"].detach()
    task_cov = B @ B.mT
    corr = float(task_cov[0, 1] / torch.sqrt(task_cov[0, 0] * task_cov[1, 1]))
    print(f"learned task correlation: {corr:.3f} (generator: strongly positive)")
    out = dict(example="torch_multitask_lmc", loss=[losses[0], losses[-1]], correlation=corr,
               finite=all(map(math.isfinite, losses)) and math.isfinite(corr))
    print("multitask LMC demo done.")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
