"""LOVE (Pleiss et al. 2018) in plain PyTorch: the cache of an exact GP's
predictions, then each query's predictive mean and variance.

The cache, as the port's documented settings state it: alpha = K^-1 y by
CG with the rank-r pivoted Cholesky preconditioner (stopping at a mean
relative residual of ``cg_tolerance``, at least 10 iterations), and an
inverse root R (R R^T ~= K^-1) from ``max_root_decomposition_size`` Lanczos
steps with full reorthogonalization (two Gram-Schmidt passes a step) from a
N(0, I) start drawn from the generator: R = Q V (Lambda)^-1/2 with
T + 1e-6 I = V Lambda V^T.  A query's mean is k(x*, x) alpha and its
variance s - |k(x*, x) R|^2, clamped at 0 (s the outputscale, k(x*, x*)).
"""

from __future__ import annotations

import torch

from . import exact_gp, rbf


def lanczos(matmul, start, steps: int):
    """(Q (n, k), T (k, k)) of ``steps`` Lanczos steps from ``start``."""
    qs = [start / torch.linalg.norm(start)]
    alphas, betas = [], []
    for i in range(steps):
        w = matmul(qs[i][:, None])[:, 0]
        alpha = qs[i] @ w
        w = w - alpha * qs[i]
        q = torch.stack(qs, dim=1)
        for _ in range(2):
            w = w - q @ (q.mT @ w)
        alphas.append(alpha)
        if i < steps - 1:
            beta = torch.linalg.norm(w)
            betas.append(beta)
            qs.append(w / beta)
    off = torch.stack(betas)
    t = torch.diag(torch.stack(alphas)) + torch.diag(off, 1) + torch.diag(off, -1)
    return torch.stack(qs, dim=1), t


def cache(x, y, ls, os, s2, settings: dict, generator, draw_dtype=torch.float32):
    """(alpha (n,), R (n, k)) in x's dtype; the Lanczos start drawn from
    ``generator`` in ``draw_dtype`` (the dtype the run under test draws in)."""
    n = x.shape[0]
    L = exact_gp.pivoted_factor(x, ls, os, settings["max_preconditioner_size"], settings["preconditioner_tolerance"])
    solve_p, _ = exact_gp.woodbury(L, s2)

    def kmm(v):
        return rbf.matmul(x, x, v, ls, os) + s2 * v

    alpha, _, _ = exact_gp.cg(kmm, y[:, None], solve_p, 0, settings["cg_tolerance"],
                                 settings["max_cg_iterations"], settings["max_lanczos_quadrature_iterations"])
    start = torch.randn((n,), dtype=draw_dtype, device=generator.device, generator=generator).to(x)
    q, t = lanczos(kmm, start, min(settings["max_root_decomposition_size"], n))
    evals, evecs = torch.linalg.eigh(t + 1e-6 * torch.eye(t.shape[0], dtype=t.dtype, device=t.device))
    evals = evals.clamp_min(0.0)
    inv_sqrt = torch.where(evals > 1e-12, evals.clamp_min(1e-12).rsqrt(), 0.0)
    return alpha[:, 0], q @ (evecs * inv_sqrt)


def predict(x, alpha, root, x_star, ls, os):
    """(mean (m,), variance (m,)) at x_star."""
    both = rbf.matmul(x_star, x, torch.cat([alpha[:, None], root], dim=1), ls, os)
    mean, v = both[:, 0], both[:, 1:]
    return mean, (os - (v * v).sum(-1)).clamp_min(0.0)
