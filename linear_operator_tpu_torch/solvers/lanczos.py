"""Batched Lanczos tridiagonalization with full reorthogonalization, and the
tridiagonal helpers of SLQ (counterpart of
linear_operator_tpu/solvers/lanczos.py).

The loop is ``num_iter`` Python steps over tensors: the breakdown flag, the
running scale and the dead-step pad are tensors used through
``torch.where``, so that no step reads the device, and each step's mat-vec
queues behind the last.  Full reorthogonalization is two classical
Gram-Schmidt passes against every earlier vector, in full float32 (a TF32
product would leave ~1e-3 of non-orthogonality).

Breakdown (an invariant subspace) is scale-relative: beta <= tol * running
max(|alpha|, beta).  From there on the recurrence is frozen: beta is 0, the
next vectors are 0, and the dead steps pad the diagonal with the last live
alpha, a block that decouples with zero first-component weight and keeps its
eigenvalues inside the spectrum's hull.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import settings
from ..utils.cholesky import highest_matmul_precision


class LanczosResult(NamedTuple):
    q_mat: torch.Tensor  # (*b, n, k) orthonormal Lanczos basis
    t_mat: torch.Tensor  # (*b, k, k) symmetric tridiagonal


def lanczos_tridiag(
    matmul_closure: Callable[[torch.Tensor], torch.Tensor],
    num_iter: int,
    *,
    init_vecs: torch.Tensor,
    tol: float = 1e-6,
) -> LanczosResult:
    """``num_iter`` Lanczos steps of the operator behind ``matmul_closure``
    ((*b, n, 1) -> (*b, n, 1)) from one start vector per batch element,
    ``init_vecs`` (*b, n).  Returns Q (*b, n, k) and T (*b, k, k), k =
    min(num_iter, n), with K ~= Q T Q^T."""
    settings.record_linalg("lanczos_tridiag", init_vecs.shape)
    n = init_vecs.shape[-1]
    k = min(num_iter, n)
    dtype = torch.promote_types(init_vecs.dtype, torch.float32)
    v = init_vecs.to(dtype)

    def mm(q):
        return matmul_closure(q[..., None])[..., 0].to(dtype)

    qs = [v / torch.linalg.norm(v, dim=-1, keepdim=True)]
    alphas, betas = [], []
    batch = v.shape[:-1]
    alive = torch.ones(batch, dtype=torch.bool, device=v.device)
    scale = torch.zeros(batch, dtype=dtype, device=v.device)  # running max(|alpha|, beta)
    pad_alpha = torch.zeros(batch, dtype=dtype, device=v.device)  # last live alpha
    for i in range(k):
        qi = qs[i]
        w = mm(qi)
        alpha = torch.sum(qi * w, dim=-1)
        w = w - alpha[..., None] * qi
        # two classical Gram-Schmidt passes against q_0 .. q_i
        Q = torch.stack(qs, dim=-1)
        with highest_matmul_precision():
            for _ in range(2):
                coeffs = (Q.mT @ w[..., None])[..., 0]
                w = w - (Q @ coeffs[..., None])[..., 0]
        beta = torch.linalg.norm(w, dim=-1)
        pad_alpha = torch.where(alive, alpha, pad_alpha)
        alphas.append(pad_alpha)
        scale = torch.maximum(scale, torch.maximum(torch.abs(alpha), beta))
        alive = alive & (beta > tol * scale)
        if i < k - 1:
            safe_beta = torch.where(alive, beta, 1.0)
            qs.append(torch.where(alive[..., None], w / safe_beta[..., None], 0.0))
            betas.append(torch.where(alive, beta, 0.0))
    diag = torch.stack(alphas, dim=-1)
    off = torch.stack(betas, dim=-1) if betas else diag[..., :0]
    return LanczosResult(torch.stack(qs, dim=-1), _build_tridiag(diag, off))


def _build_tridiag(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Dense symmetric tridiagonal matrices (..., m, m) from diag (..., m)
    and off (..., m - 1)."""
    T = torch.diag_embed(diag)
    if diag.shape[-1] > 1:
        T = T + torch.diag_embed(off, offset=1) + torch.diag_embed(off, offset=-1)
    return T


def lanczos_tridiag_to_diag(t_mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecompose small tridiagonal matrices, clamping negative
    eigenvalues (and their vectors) to zero.  The eigensolve runs in
    ``settings._linalg_dtype_symeig`` (float64 by default).  Returns
    (evals (*b, k), evecs (*b, k, k)) in the input dtype."""
    settings.record_linalg("symeig", t_mat.shape)
    dtype = t_mat.dtype
    evals, evecs = torch.linalg.eigh(t_mat.to(settings._linalg_dtype_symeig.value()))
    mask = evals >= 0
    evals = torch.where(mask, evals, 0.0)
    evecs = torch.where(mask[..., None, :], evecs, 0.0)
    return evals.to(dtype), evecs.to(dtype)
