"""Numerically stable QR and pseudo-inverse (counterpart of
linear_operator_tpu/utils/qr.py).

The QR stays on the tensor's device (``settings.stable_qr_host_threshold``
is kept for the API only, as in the JAX package); a near-singular R gets its
dead diagonal entries bumped, without a branch on the data, so that
triangular solves against it stay finite.
"""

from __future__ import annotations

import torch

from .cholesky import highest_matmul_precision


def stable_qr(mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR of (*b, m, n) with the diagonal of a near-singular R
    regularized: Q, R."""
    q, r = torch.linalg.qr(mat)
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    max_diag = torch.amax(torch.abs(diag), dim=-1, keepdim=True)
    bad = torch.abs(diag) < 1e-10 * torch.clamp_min(max_diag, 1e-30)
    # a bumped entry keeps its sign (a zero one goes positive)
    sign = torch.sign(diag) + (diag == 0).to(diag.dtype)
    bump = torch.where(bad, sign, torch.zeros_like(diag)) * 1e-8 * torch.clamp_min(max_diag, 1.0)
    r = r.clone()
    r.diagonal(dim1=-2, dim2=-1).add_(bump)
    return q, r


def stable_pinverse(mat: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse R^{-1} Q^T of a tall full-rank (*b, m, n) matrix by QR
    and a triangular solve; a wide one through its transpose."""
    if mat.shape[-2] >= mat.shape[-1]:
        q, r = stable_qr(mat)
        eye = torch.eye(r.shape[-1], dtype=mat.dtype, device=mat.device).expand(r.shape)
        rinv = torch.linalg.solve_triangular(r, eye, upper=True)
        with highest_matmul_precision():
            return rinv @ q.mT
    return stable_pinverse(mat.mT).mT
