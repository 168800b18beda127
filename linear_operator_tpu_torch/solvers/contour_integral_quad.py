"""Contour integral quadrature for K^{-1/2} b and K^{1/2} b (Hale, Higham
and Trefethen; counterpart of
linear_operator_tpu/solvers/contour_integral_quad.py).

K^{-1/2} b = sum_j w_j (K + s_j I)^{-1} b, with shifts and weights from an
elliptic-integral quadrature over the spectrum's range [lmin, lmax], which a
short Lanczos run (or preconditioned CG) estimates.  The elliptic functions
are computed in torch, in the rhs's dtype, with a fixed number of AGM steps,
as the JAX package computes them; the shifts and weights are constants to
autograd.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .. import settings
from .lanczos import lanczos_tridiag
from .minres import minres

_AGM_ITERS = 14


def ellipk_agm(m: torch.Tensor) -> torch.Tensor:
    """Complete elliptic integral K(m) by the AGM: pi / (2 agm(1, sqrt(1 - m)))."""
    a = torch.ones_like(m)
    b = torch.sqrt(torch.clamp_min(1.0 - m, 1e-30))
    for _ in range(_AGM_ITERS):
        a, b = (a + b) / 2.0, torch.sqrt(torch.clamp_min(a * b, 0.0))
    return math.pi / (2.0 * a)


def ellipj(u: torch.Tensor, m: torch.Tensor):
    """Jacobi elliptic sn, cn, dn by the descending AGM (Abramowitz and
    Stegun 16.4) with a fixed number of steps."""
    a_list, c_list = [], []
    a = torch.ones_like(u) + 0.0 * m
    b = torch.sqrt(torch.clamp_min(1.0 - m, 1e-30)) * torch.ones_like(a)
    c = torch.sqrt(torch.clamp_min(m, 0.0)) * torch.ones_like(a)
    for _ in range(_AGM_ITERS):
        a_list.append(a)
        c_list.append(c)
        a, b, c = (a + b) / 2.0, torch.sqrt(torch.clamp_min(a * b, 0.0)), (a - b) / 2.0
    a_list.append(a)
    c_list.append(c)
    phi = (2.0**_AGM_ITERS) * a * u
    for i in range(_AGM_ITERS, 0, -1):
        ratio = torch.clamp(c_list[i] / a_list[i], -1.0, 1.0)
        phi = (phi + torch.asin(ratio * torch.sin(phi))) / 2.0
    sn = torch.sin(phi)
    cn = torch.cos(phi)
    dn = torch.sqrt(torch.clamp_min(1.0 - m * sn * sn, 1e-30))
    return sn, cn, dn


def ciq_shifts_weights(min_eig: torch.Tensor, max_eig: torch.Tensor, num_quad: int):
    """Quadrature shifts and weights, each (num_quad,), with

        K^{-1/2} b ~= sum_j weights_j (K + shifts_j I)^{-1} b

    for a spectrum inside [min_eig, max_eig]; constants to autograd."""
    min_eig = torch.clamp_min(min_eig.detach(), 1e-10)
    max_eig = torch.maximum(max_eig.detach(), min_eig * (1 + 1e-6))
    k2 = min_eig / max_eig  # the modulus squared
    Kp = ellipk_agm(1.0 - k2)  # K'(k)
    u = (torch.arange(num_quad, dtype=min_eig.dtype, device=min_eig.device) + 0.5) * Kp / num_quad
    # Jacobi's imaginary transformation at t = i u:
    #   sn(t, k) = i sn(u, k') / cn(u, k'), cn(t, k) = 1 / cn(u, k'),
    #   dn(t, k) = dn(u, k') / cn(u, k')
    sn_u, cn_u, dn_u = ellipj(u, 1.0 - k2)
    sn_t_im = sn_u / cn_u
    dn_t = dn_u / cn_u
    cn_t = 1.0 / cn_u
    # the poles w^2 = -min_eig Im(sn(t))^2 are negative: K - w^2 I = K + shift I
    shifts = min_eig * sn_t_im * sn_t_im
    dzdt = cn_t * dn_t
    constant = -2.0 * Kp * torch.sqrt(min_eig) / (math.pi * num_quad)
    weights = -dzdt * constant
    return shifts, weights


def ciq_eig_range(
    matmul_closure: Callable[[torch.Tensor], torch.Tensor],
    init: torch.Tensor,
    max_lanczos_iter: int = 20,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """(min_eig, max_eig), scalars, from the Ritz values of ``max_lanczos_iter``
    Lanczos steps from ``init`` (*b, n), or with a preconditioner those of the
    whitened pencil from preconditioned CG's tridiagonal, widened by 1.2 on
    each side and reduced over the batch, so that the shifts are shared."""
    n = init.shape[-1]
    k = min(max_lanczos_iter, n)
    if preconditioner is None:
        _, T = lanczos_tridiag(matmul_closure, k, init_vecs=init)
    else:
        from .linear_cg import linear_cg

        res = linear_cg(
            matmul_closure, init[..., None], n_tridiag=1, max_iter=k, max_tridiag_iter=k,
            tolerance=1e-5, preconditioner=preconditioner,
        )
        T = res.t_mats[0]  # (*b, k, k): the leading dim is the tridiagonal's column
    ritz = torch.linalg.eigvalsh(T)
    # dead-step pads sit inside the spectrum's hull (the Lanczos breakdown
    # convention); the 1.2 factors absorb the estimate's error
    top = torch.amax(ritz, dim=-1)
    max_eig = top * 1.2
    min_eig = torch.maximum(torch.amin(ritz, dim=-1), 1e-7 * top) / 1.2
    return torch.amin(min_eig).to(init.dtype), torch.amax(max_eig).to(init.dtype)


def contour_integral_quad(
    matmul_closure: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    *,
    init: torch.Tensor,
    num_quad: int | None = None,
    max_lanczos_iter: int = 20,
    inverse: bool = True,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
    sqrt_premultiply: Callable[[torch.Tensor], torch.Tensor] | None = None,
    quadrature: tuple[torch.Tensor, torch.Tensor] | None = None,
    tolerance: float | None = None,
    max_iter: int | None = None,
):
    """K^{-1/2} rhs (``inverse``) or K^{1/2} rhs by shifted MINRES.

    Returns (solves (q, *b, n, t), shifts (q,), weights (q,)) with the result
    sum_j weights_j solves_j.  ``init`` (*b, n) is the range estimate's start
    vector; ``quadrature``, (shifts, weights) from an earlier call on the same
    operator, skips the estimate.  With ``inverse=False`` each solve gets one
    more product with K: sum_j w_j K (K + s_j)^{-1} rhs = K^{1/2} rhs.

    With ``preconditioner`` (z -> P^{-1} z) and ``sqrt_premultiply``
    (r -> P^{1/2} r) the quadrature runs over the whitened spectrum of
    P^{-1/2} K P^{-1/2}, and each solve is (K + s_j P)^{-1} P^{1/2} rhs: the
    weighted sum is M rhs with M M^T = K^{-1} exactly."""
    if num_quad is None:
        num_quad = settings.num_contour_quadrature.value()
    settings.record_linalg("contour_integral_quad", rhs.shape)
    if sqrt_premultiply is not None:
        rhs = sqrt_premultiply(rhs)
    if quadrature is None:
        min_eig, max_eig = ciq_eig_range(matmul_closure, init, max_lanczos_iter, preconditioner)
        quadrature = ciq_shifts_weights(min_eig, max_eig, num_quad)
    shifts, weights = (a.to(rhs.dtype) for a in quadrature)
    solves = minres(
        matmul_closure,
        rhs,
        shifts=shifts,
        max_iter=settings.max_cg_iterations.value() if max_iter is None else max_iter,
        tolerance=settings.minres_tolerance.value() if tolerance is None else tolerance,
        preconditioner=preconditioner,
    )
    if not inverse:
        # one product over the leading shift dim: (q, *b, n, t) at once
        solves = matmul_closure(solves)
    return solves, shifts, weights
