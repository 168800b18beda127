"""Batched, shifted, preconditioned MINRES: (K + shift_i P) x = b for many
shifts at once (counterpart of linear_operator_tpu/solvers/minres.py).

All shifts share one Lanczos recurrence (the same Krylov space); only the
Givens QR of the shifted tridiagonal differs per shift, so an iteration costs
one mat-vec of the (*b, n, t) basis plus O(shifts) vector updates.  The JAX
package runs the iteration as one ``lax.while_loop``; here it is a Python
loop that reads one flag from the device per iteration, the mean relative
residual's test.  The solution carries a leading shift dimension.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import settings
from ..utils.warnings import debug_nan_check


def minres(
    matmul_closure: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    *,
    shifts: torch.Tensor | None = None,
    max_iter: int | None = None,
    tolerance: float | None = None,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Solutions of shape (num_shifts, *b, n, t), or (*b, n, t) when
    ``shifts`` is None (one zero shift, squeezed).

    ``preconditioner`` (z -> P^{-1} z, SPD) runs the preconditioned Lanczos
    recurrence: the basis pair (z, q = P^{-1} z) with beta = sqrt(z . q), so
    that each system solved is (K + shift P) x = b.  Without one, q is z.
    Under ``settings.verbose_linalg`` the iteration count is logged."""
    if tolerance is None:
        tolerance = settings.minres_tolerance.value()
    if max_iter is None:
        max_iter = settings.max_cg_iterations.value()
    settings.record_linalg("minres", rhs.shape)
    debug_nan_check("minres", rhs)

    squeeze_rhs = rhs.ndim == 1
    if squeeze_rhs:
        rhs = rhs[:, None]
    squeeze_shift = shifts is None
    if shifts is None:
        shifts = torch.zeros((1,), dtype=rhs.dtype, device=rhs.device)
    s = shifts.shape[0]

    dtype = torch.promote_types(rhs.dtype, torch.float32)
    b = rhs.to(dtype)
    n, t = b.shape[-2], b.shape[-1]
    batch = b.shape[:-2]
    max_iter = min(max_iter, 2 * n + 10)

    def mm(v):
        return matmul_closure(v.to(rhs.dtype)).to(dtype)

    if preconditioner is None:
        def prec(v):
            return v
    else:
        def prec(v):
            return preconditioner(v.to(rhs.dtype)).to(dtype)

    b_norm = torch.linalg.norm(b, dim=-2, keepdim=True)
    b_is_zero = b_norm < 1e-10
    b_norm = torch.where(b_is_zero, 1.0, b_norm)
    b_hat = b / b_norm

    # generalized Lanczos start: beta0 = sqrt(z . P^{-1} z), 1 without P
    q0_raw = prec(b_hat)
    beta0 = torch.sqrt(torch.clamp_min(torch.sum(b_hat * q0_raw, dim=-2, keepdim=True), 1e-30))
    z_prev = torch.zeros_like(b_hat)
    z_cur = b_hat / beta0
    q_cur = q0_raw / beta0
    beta = torch.zeros((*batch, 1, t), dtype=dtype, device=b.device)

    x = torch.zeros((s, *batch, n, t), dtype=dtype, device=b.device)
    w0 = torch.zeros_like(x)  # search direction k-1
    w1 = torch.zeros_like(x)  # search direction k-2
    ones = torch.ones((s, *batch, 1, t), dtype=dtype, device=b.device)
    c0, s0, c1, s1 = ones, torch.zeros_like(ones), ones, torch.zeros_like(ones)  # Givens rotations
    eta = beta0.expand(s, *batch, 1, t)  # residual-norm proxy
    shifts_exp = shifts.reshape(s, *([1] * (len(batch) + 2))).to(dtype)

    k = 0
    mean_rel = 1.0
    while k < max_iter and mean_rel >= tolerance:
        # the shared (preconditioned) Lanczos step on K; each shift enters
        # only its own QR
        p = mm(q_cur)
        alpha = torch.sum(q_cur * p, dim=-2, keepdim=True)  # (*b, 1, t)
        p = p - alpha * z_cur - beta * z_prev
        q_raw = prec(p)
        beta_next = torch.sqrt(torch.clamp_min(torch.sum(p * q_raw, dim=-2, keepdim=True), 0.0))
        dead = beta_next < 1e-30
        safe_beta = torch.where(dead, 1.0, beta_next)
        z_next = torch.where(dead, 0.0, p / safe_beta)
        q_next = torch.where(dead, 0.0, q_raw / safe_beta)

        # the Givens QR of each shifted tridiagonal
        alpha_s = alpha[None] + shifts_exp  # (s, *b, 1, t)
        beta_k = beta[None]
        delta = c1 * alpha_s - c0 * s1 * beta_k
        rho1 = torch.sqrt(delta * delta + beta_next[None] ** 2)
        rho2 = s1 * alpha_s + c0 * c1 * beta_k
        rho3 = s0 * beta_k
        safe_rho1 = torch.where(rho1 < 1e-30, 1.0, rho1)
        c_new = delta / safe_rho1
        s_new = beta_next[None] / safe_rho1

        w = (q_cur[None] - rho3 * w1 - rho2 * w0) / safe_rho1
        x = x + c_new * eta * w
        eta = -s_new * eta

        z_prev, z_cur, q_cur, beta = z_cur, z_next, q_next, beta_next
        w1, w0 = w0, w
        c0, s0, c1, s1 = c1, s1, c_new, s_new
        k += 1
        # eta starts at beta0 (the P-norm scale): normalized, the tolerance
        # stays relative with or without a preconditioner
        mean_rel = float(torch.mean(torch.abs(eta) / beta0))

    if settings.verbose_linalg.on():
        settings.logger.debug("minres finished in %d iterations, mean relative residual %.3e", k, mean_rel)
    x = torch.where(b_is_zero[None], 0.0, x * b_norm[None]).to(rhs.dtype)
    if squeeze_rhs:
        x = x[..., 0]
    if squeeze_shift:
        x = x[0]
    return x
