"""Batched preconditioned conjugate gradients with Lanczos tridiagonal
extraction (counterpart of linear_operator_tpu/solvers/linear_cg.py).

The JAX package runs the solve as one ``lax.while_loop``; here it is a Python
loop on the host.  What it keeps: the per-column convergence mask (converged
columns get alpha = beta = 0 and stop moving), the tridiagonal entries of the
first ``n_tridiag`` columns written into fixed buffers whose unused tail is an
identity pad (diagonal 1, off-diagonal 0, so SLQ gives it zero weight), at
least ``min_iter = 10`` iterations, and the same stopping rule.  The stopping
test reads one flag from the device per iteration, and none while the
tridiagonal iterations are still running.

Every reduction over the matrix rows and columns goes through a
``reduction`` (:class:`LocalReduction`, the identity, by default).  On a
mesh (``parallel/``) it all-reduces the row sums of a row-sharded operator,
takes the mean residual over the columns of every probe rank and the
stopping flags' "any" over every rank, so that each rank runs exactly the
iterations of the unsharded solve; the host read of the flag is then one
collective.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import torch

from .. import settings
from ..utils.warnings import NumericalWarning, debug_nan_check
from .lanczos import _build_tridiag


class CGResult(NamedTuple):
    solution: torch.Tensor  # (*b, n, t)
    t_mats: torch.Tensor | None  # (nt, *b, tmax, tmax) or None
    residual_norm: torch.Tensor  # (*b, t) final relative residual per column
    num_iters: int


def _safe_div(num: torch.Tensor, den: torch.Tensor, tiny: float = 1e-35) -> torch.Tensor:
    """num / den with the denominator clamped away from 0, far below any
    legitimate value (pAp ~ resid^2 once CG converges)."""
    tiny_t = den.new_tensor(tiny)
    clamped = torch.where(den < 0, -tiny_t, tiny_t)
    return num / torch.where(den.abs() < tiny, clamped, den)


class LocalReduction:
    """CG's reductions over the rows (dim -2) and the columns of one
    process's operands; ``parallel.sharding.MeshReduction`` makes them global.
    ``tridiag`` says whether some rank builds tridiagonal matrices (and so
    skips the stopping test while they run) where this one has no probe
    column of its own."""

    tridiag = False

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.norm(a, dim=-2, keepdim=True)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.sum(a * b, dim=-2, keepdim=True)

    def norm_dot(self, r: torch.Tensor, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(|r|, r . z), the two reductions after a CG update, together."""
        return self.norm(r), self.dot(r, z)

    def column_mean(self, resid: torch.Tensor) -> torch.Tensor:
        """The mean residual over the columns, (*b, 1, t) -> (*b)."""
        return resid.mean(dim=(-2, -1))

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        return flags


_LOCAL = LocalReduction()


def linear_cg(
    matmul_closure: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    *,
    tolerance: float | None = None,
    eps: float = 1e-10,
    stop_updating_after: float = 1e-10,
    max_iter: int | None = None,
    max_tridiag_iter: int | None = None,
    initial_guess: torch.Tensor | None = None,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] | None = None,
    n_tridiag: int = 0,
    reduction: LocalReduction | None = None,
) -> CGResult:
    """Solve ``K x = rhs`` for PSD ``K`` given only a mat-vec closure; all
    ``t`` columns of ``rhs`` (*batch, n, t) are solved in one loop, and the
    first ``n_tridiag`` columns also give Lanczos tridiagonal matrices.
    ``reduction`` makes the row and column reductions global on a mesh
    (``rhs`` is then this rank's block)."""
    red = _LOCAL if reduction is None else reduction
    if tolerance is None:
        tolerance = settings.cg_tolerance.value()
    if max_iter is None:
        max_iter = settings.max_cg_iterations.value()
    if max_tridiag_iter is None:
        max_tridiag_iter = settings.max_lanczos_quadrature_iterations.value()

    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]

    n = rhs.shape[-2]
    batch = rhs.shape[:-2]
    if settings.terminate_cg_by_size.on():
        max_iter = n
        max_tridiag_iter = min(max_tridiag_iter, n)
    max_iter = min(max_iter, 10 * n + 10)
    n_tridiag_iter = min(max_tridiag_iter, max_iter)
    min_iter = min(10, max_iter)
    settings.record_linalg("linear_cg", rhs.shape)
    debug_nan_check("linear_cg", rhs)

    orig_dtype = rhs.dtype
    dtype = torch.promote_types(orig_dtype, torch.float32)
    rhs = rhs.to(dtype)
    precond = preconditioner if preconditioner is not None else (lambda v: v)

    # normalized columns make the tolerances scale-free
    rhs_norm = red.norm(rhs)  # (*b, 1, t)
    rhs_is_zero = rhs_norm < eps
    rhs_norm = torch.where(rhs_is_zero, 1.0, rhs_norm)
    rhs = rhs / rhs_norm

    def mm(v):
        return matmul_closure(v.to(orig_dtype)).to(dtype)

    if initial_guess is None:
        x = torch.zeros_like(rhs)
        r = rhs
    else:
        x = (initial_guess.to(dtype) / rhs_norm).expand(rhs.shape)
        r = rhs - mm(x)

    z = precond(r)
    p = z
    resid, rz = red.norm_dot(r, z)
    has_converged = resid < stop_updating_after

    nt = max(n_tridiag, 1)
    tmax = max(n_tridiag_iter, 1)
    t_diag = torch.ones((tmax, *batch, nt), dtype=dtype, device=rhs.device)
    t_off = torch.zeros((tmax, *batch, nt), dtype=dtype, device=rhs.device)
    prev_alpha = torch.zeros((*batch, 1, nt), dtype=dtype, device=rhs.device)
    prev_beta = prev_alpha

    k = 0
    while k < max_iter:
        tridiag_active = n_tridiag > 0 and k < n_tridiag_iter
        if not ((n_tridiag > 0 or red.tridiag) and k < n_tridiag_iter):
            # run while any batch element is unconverged (or below min_iter),
            # unless every column is frozen
            flags = torch.stack([(red.column_mean(resid) >= tolerance).any(), ~has_converged.all()])
            flags = red.any(flags)
            if not bool((flags[0] | (k < min_iter)) & flags[1]):
                break

        Ap = mm(p)
        pAp = red.dot(p, Ap)
        alpha = torch.where(has_converged, 0.0, _safe_div(rz, pAp))

        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        resid, rz_new = red.norm_dot(r, z)
        has_converged = has_converged | (resid < stop_updating_after)

        beta = torch.where(has_converged, 0.0, _safe_div(rz_new, rz))
        p = z + beta * p
        rz = rz_new

        if tridiag_active:
            # T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1};  T[k,k+1] = sqrt(beta_k)/alpha_k.
            # A masked (converged) column pads with identity.
            a_t = alpha[..., 0, :n_tridiag]
            b_t = beta[..., 0, :n_tridiag]
            pa = prev_alpha[..., 0, :]
            pb = prev_beta[..., 0, :]
            a_zero = a_t == 0.0
            a_safe = torch.where(a_zero, 1.0, a_t)
            pa_zero = pa == 0.0
            diag_entry = 1.0 / a_safe + torch.where(pa_zero, 0.0, pb / torch.where(pa_zero, 1.0, pa))
            t_diag[k] = torch.where(a_zero, 1.0, diag_entry)
            off_entry = torch.sqrt(torch.clamp_min(b_t, 0.0)) / a_safe
            t_off[k] = torch.where(a_zero, 0.0, off_entry)
            prev_alpha = alpha[..., :, :n_tridiag]
            prev_beta = beta[..., :, :n_tridiag]

        k += 1

    max_resid = float(red.column_mean(resid).max())
    if settings.verbose_linalg.on():
        settings.logger.debug(
            "linear_cg finished in %d iterations, mean residual %.3e", k, max_resid
        )
    if max_resid >= tolerance:
        warnings.warn(
            f"CG terminated in {k} iterations with mean residual {max_resid:.3e} >= "
            f"tolerance {tolerance}. If performance is affected, consider raising "
            "max_cg_iterations or using a preconditioner.",
            NumericalWarning,
        )

    solution = torch.where(rhs_is_zero, 0.0, x * rhs_norm).to(orig_dtype)
    residual_norm = torch.where(rhs_is_zero, 0.0, red.norm(r))[..., 0, :]

    t_mats = None
    if n_tridiag > 0:
        diag = t_diag.movedim(0, -1)  # (*b, nt, tmax)
        off = t_off.movedim(0, -1)[..., : tmax - 1]
        t_mats = _build_tridiag(diag, off).movedim(-3, 0)  # (nt, *b, tmax, tmax)

    if squeeze:
        solution = solution[..., 0]
    return CGResult(solution, t_mats, residual_norm.to(orig_dtype), k)
