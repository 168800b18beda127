"""Tridiagonal helpers of the Lanczos solvers (counterpart of the parts of
linear_operator_tpu/solvers/lanczos.py that SLQ needs)."""

from __future__ import annotations

import torch

from .. import settings


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
