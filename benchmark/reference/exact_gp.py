"""The exact GP's training step in plain PyTorch: GPyTorch's BBMM estimate
of the negative marginal log-likelihood a point (Gardner et al. 2018) and
the gradient of that estimate, under the port's documented settings, and
Adam over the three raw hyperparameters.

The estimate, for K = k(x, x) + s2 I with k an RBF:

- P = L L^T + s2 I, with L the rank-r greedy pivoted Cholesky factor of
  k(x, x) (trace tolerance ``tol``);
- m probes z = L e1 + sqrt(s2) e2, drawn N(0, P) from the step's generator
  (e1 (m, r) first, then e2 (m, n), each N(0, 1) in float32), normalized;
- one preconditioned CG over [z / |z| | y]: its first ``lanczos`` iterations
  give each probe's Lanczos tridiagonal matrix, then it runs until the mean
  relative residual over the columns falls under ``cg_tolerance`` (at least
  10 iterations, at most ``max_cg``);
- log|K| ~= n mean_j sum_i (e1^T v_ij)^2 log theta_ij + log|P|, y^T K^-1 y
  from the CG solution; loss = (y^T K^-1 y + log|K| + n log 2 pi) / (2 n);
- its gradient from the same solves (no further CG): d log|K| ~= (1/m)
  sum_j |z_j|^2 <K^-1 z^_j, dK P^-1 z^_j>, d y^T K^-1 y = -<K^-1 y, dK K^-1 y>.

It runs in the dtype of the inputs it is given: float32 with TF32 off for
the configuration here, whose stated precision that is.  The estimate is
unconverged by design (CG stops at a mean relative residual of 1), and its
finite-precision trajectory is part of it: float32 arithmetic alone moves it
from float64's by ~5e-3 nats a point at n = 1e5 (55 CG iterations against
42, the probes' Lanczos vectors losing orthogonality), more than the port
differs from this file in float32 (~5e-4) and less than TF32 does (~1e-2).
Everything is worked out here from x, y, the initial parameters and each
step's generator state; the greedy pivots are this file's own (ties to the
lowest index, as torch.argmax).
"""

from __future__ import annotations

import math

import torch

from . import rbf


def softplus(r):
    return torch.logaddexp(r, torch.zeros_like(r)) + 1e-6


def pivoted_factor(x, ls, os, rank: int, tol: float):
    """L (n, rank): the greedy pivoted Cholesky factor of k(x, x); a step
    after the residual trace fell under ``tol`` of the first (or the pivot
    under 1e-12) gives a zero column."""
    n = x.shape[0]
    d = torch.full((n,), float(os), dtype=x.dtype, device=x.device)
    total = float(d.sum())
    cols = []
    for _ in range(rank):
        p = int(torch.argmax(d))
        dp = float(d[p])
        if not (float(d.clamp_min(0.0).sum()) > tol * total and dp > 1e-12):
            cols.append(torch.zeros(n, dtype=x.dtype, device=x.device))
            continue
        col = rbf.column(x, p, ls, os)
        if cols:
            L = torch.stack(cols, dim=-1)
            col = col - L @ L[p]
        li = col / math.sqrt(dp)
        d = d - li * li
        d[p] = -math.inf
        cols.append(li)
    return torch.stack(cols, dim=-1)


def woodbury(L, s2):
    """(v -> (L L^T + s2 I)^-1 v, log|L L^T + s2 I|)."""
    n, r = L.shape
    cap = torch.eye(r, dtype=L.dtype, device=L.device) + (L.mT @ L) / s2
    c = torch.linalg.cholesky(cap)

    def solve(v):
        t = torch.cholesky_solve(L.mT @ v / s2, c)
        return v / s2 - (L @ t) / s2

    return solve, n * math.log(s2) + 2.0 * torch.log(torch.diagonal(c)).sum()


def cg(matmul, rhs, precond, n_tridiag: int, tolerance: float, max_iter: int, max_tridiag: int):
    """Preconditioned CG on the columns of ``rhs`` with the port's rules
    (normalized columns, a frozen column once its residual is under 1e-10,
    at least 10 iterations, the stopping test skipped while the tridiagonal
    iterations run), and the first ``n_tridiag`` columns' tridiagonal
    matrices.  Returns (solution, tridiagonals (n_tridiag, k, k),
    iterations)."""
    norm = torch.linalg.norm(rhs, dim=0, keepdim=True)
    zero = norm < 1e-10
    norm = torch.where(zero, torch.ones_like(norm), norm)
    b = rhs / norm
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    resid = torch.linalg.norm(r, dim=0, keepdim=True)
    rz = (r * z).sum(0, keepdim=True)
    frozen = resid < 1e-10
    tmax = min(max_tridiag, max_iter)
    t_diag = torch.ones(tmax, n_tridiag, dtype=b.dtype, device=b.device)
    t_off = torch.zeros(tmax, n_tridiag, dtype=b.dtype, device=b.device)
    prev_a = torch.zeros(1, n_tridiag, dtype=b.dtype, device=b.device)
    prev_b = prev_a
    k = 0
    while k < max_iter:
        if not (n_tridiag > 0 and k < tmax):
            if not ((float(resid.mean()) >= tolerance or k < 10) and not bool(frozen.all())):
                break
        ap = matmul(p)
        alpha = torch.where(frozen, torch.zeros_like(rz), rz / (p * ap).sum(0, keepdim=True))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        resid = torch.linalg.norm(r, dim=0, keepdim=True)
        rz_new = (r * z).sum(0, keepdim=True)
        frozen = frozen | (resid < 1e-10)
        beta = torch.where(frozen, torch.zeros_like(rz), rz_new / rz)
        p = z + beta * p
        rz = rz_new
        if n_tridiag > 0 and k < tmax:
            a_t, b_t = alpha[:, :n_tridiag], beta[:, :n_tridiag]
            a_zero, pa_zero = a_t == 0.0, prev_a == 0.0
            a_safe = torch.where(a_zero, torch.ones_like(a_t), a_t)
            entry = 1.0 / a_safe + torch.where(pa_zero, 0.0, prev_b / torch.where(pa_zero, 1.0, prev_a))
            t_diag[k] = torch.where(a_zero, 1.0, entry)[0]
            t_off[k] = torch.where(a_zero, 0.0, torch.sqrt(b_t.clamp_min(0.0)) / a_safe)[0]
            prev_a, prev_b = a_t, b_t
        k += 1
    solution = torch.where(zero, 0.0, x * norm)
    t = torch.diag_embed(t_diag.mT) + torch.diag_embed(t_off.mT[:, :-1], 1) + torch.diag_embed(t_off.mT[:, :-1], -1)
    return solution, t, k


def loss_and_grad(x, y, raw, settings: dict, generator, draw_dtype=torch.float32):
    """The estimate at raw = (raw lengthscale, raw outputscale, raw noise)
    and its gradient with respect to them, with the probes drawn from
    ``generator`` in ``draw_dtype`` (the dtype the run under test draws in).
    Returns (loss, grad (3,), CG iterations)."""
    n = x.shape[0]
    m = settings["num_trace_samples"]
    ls, os, s2 = (float(v) for v in softplus(raw))
    L = pivoted_factor(x, ls, os, settings["max_preconditioner_size"], settings["preconditioner_tolerance"])
    solve_p, logdet_p = woodbury(L, s2)
    e1 = torch.randn((m, L.shape[1]), dtype=draw_dtype, device=generator.device, generator=generator)
    e2 = torch.randn((m, n), dtype=draw_dtype, device=generator.device, generator=generator)
    z = L @ e1.to(x).mT + math.sqrt(s2) * e2.to(x).mT  # (n, m)
    norms = torch.linalg.norm(z, dim=0, keepdim=True)
    probes, pz = z / norms, solve_p(z) / norms

    def kmm(v):
        return rbf.matmul(x, x, v, ls, os) + s2 * v

    sol, t, iters = cg(kmm, torch.cat([probes, y[:, None]], dim=1), solve_p, m, settings["cg_tolerance"],
                       settings["max_cg_iterations"], settings["max_lanczos_quadrature_iterations"])
    evals, evecs = torch.linalg.eigh(t.double())
    valid = evals > 0
    weights = torch.where(valid, evecs[:, 0, :] ** 2, 0.0)
    logdet = n * (weights * torch.log(torch.where(valid, evals, 1.0))).sum(-1).mean() + logdet_p
    iq = (sol[:, m] * y).sum()
    loss = 0.5 * (iq + logdet.to(iq) + n * math.log(2.0 * math.pi)) / n
    # the gradient: one bilinear form over the stacked left and right vectors
    bar = 0.5 / n
    left = torch.cat([sol[:, :m] * (bar * norms**2 / m), -bar * sol[:, m:]], dim=1)
    right = torch.cat([pz, sol[:, m:]], dim=1)
    d_ls, d_os = rbf.bilinear(x, left, right, ls, os)
    d_s2 = (left * right).sum()
    grad = torch.stack([d_ls, d_os, d_s2]) * torch.sigmoid(raw)
    return loss, grad, iters


def training_steps(x, y, raw0, settings: dict, lr: float, generators):
    """Adam (lr, PyTorch's defaults otherwise) from raw0 over len(generators)
    steps, each step's probes from its generator (one generator may stand
    for several steps), computed in x's dtype.  Returns {"losses", "grad0"
    (|g| a leaf at the first step), "change" (|raw - raw0| a leaf after the
    steps), "cg_iterations", "records" (each step's generator state before
    it)} in the shape of a run's record."""
    raw = raw0.clone().requires_grad_(True)
    opt = torch.optim.Adam([raw], lr=lr)
    losses, grad0, iters, records = [], None, [], []
    for gen in generators:
        records.append({"generator_state": gen.get_state()})
        with torch.no_grad():
            loss, grad, cg_iters = loss_and_grad(x, y, raw.detach(), settings, gen)
        raw.grad = grad.to(raw.dtype)
        opt.step()
        losses.append(float(loss))
        iters.append(cg_iters)
        if grad0 is None:
            grad0 = [abs(float(g)) for g in grad]
    change = [abs(float(v)) for v in (raw.detach() - raw0)]
    names = ("raw_lengthscale", "raw_outputscale", "raw_noise")
    return {"losses": losses, "grad0": dict(zip(names, grad0)), "change": dict(zip(names, change)),
            "cg_iterations": iters, "records": records}
